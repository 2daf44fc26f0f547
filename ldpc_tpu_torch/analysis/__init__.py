"""Analyses of the port: the roofline accounting, graph statistics
(``graph_stats``) and EXIT charts (``exit``). The rest of
``ldpc_tpu/analysis/`` (failures, importance, learned min-sum, density
evolution) is queued in ROADMAP.md."""

from ldpc_tpu_torch.analysis.roofline import (
    CLASSES,
    HBM_BYTES_PER_S,
    OpCount,
    channel_census,
    counter_census,
    decode_census,
    init_census,
    issue_peak_ops_per_s,
    measure_mix_rate,
    measure_rates,
    measure_tile_trips,
    speed_of_light,
    speed_of_light_two_phase,
)

__all__ = [
    "CLASSES",
    "HBM_BYTES_PER_S",
    "OpCount",
    "channel_census",
    "counter_census",
    "decode_census",
    "init_census",
    "issue_peak_ops_per_s",
    "measure_mix_rate",
    "measure_rates",
    "measure_tile_trips",
    "speed_of_light",
    "speed_of_light_two_phase",
]
