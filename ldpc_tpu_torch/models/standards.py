"""Built-in standard LDPC code families, constructed programmatically.

The reference ships a static database of 119 ALIST files
(`Channel_Codes_Database/`); this module makes the framework standalone by
*constructing* every one of those codes (and the whole parameter space around
them) from their published base-matrix descriptions:

* **IEEE 802.16e WiMAX** (`Wimax LDPC Codes/wimax_*.alist.txt`, 95 files):
  quasi-cyclic codes defined by one 24-column base matrix per rate class with
  shift coefficients given at lift size Z0 = 96 and scaled to other lifts
  Z = n/24 by ``floor(p * Z / 96)`` (the standard's scaling rule for all
  shipped rate classes; verified file-for-file against the reference DB in
  tests/test_standards.py).
* **IEEE 802.22 WRAN** (`WRAN_N*_P*.txt`, 8 files): the same base matrices at
  Z = 16 and Z = 20; the rate-5/6 Z=20 table deviates from pure scaling and is
  stored explicitly.
* **IEEE 802.11n Wi-Fi** (`wifi_648_r083.alist.txt`): rate-5/6 Z=27 table.
* **IEEE 802.11ad WiGig** (`wigig_*.alist.txt`, `ieee_802_11ad_*.alist.txt`):
  Z=42, 16-column base matrices for rates 1/2, 5/8, 3/4, 13/16.
* **CCSDS short block codes** (`CCSDS_ldpc_n{32,128,256,512}_k*.alist.txt`):
  4x8 protograph with weight-2 circulant blocks per size.
* **ITU-T G.9960 (G.hn)** (`LDPC_N336_K196_ITU_G.h.alist.txt`): Z=14 table.
* **Tanner (155, 64)** (`Tanner_155_64.alist.txt`): the algebraic
  construction -- block (r, c) of the 3x5 base carries shift
  ``5^r * 2^c mod 31``.
* **"wimax-like" custom sets** (`wimaxlike_N*_set0.txt`): rate-1/2 base
  structure with independently drawn shifts at Z = 8/10/14/16.
* **BCH/Hamming (7, 4)** (`BCH_7_4_1_strip.alist.txt`): the cyclic Hamming
  parity-check matrix.

All shift tables are published standards constants, embedded here in a
compact text form; the construction code is original. Every factory returns
an :class:`~ldpc_tpu_torch.models.alist.AlistMatrix`, interchangeable with files
read by `read_alist` (utils.py:21 in the reference defines that format).
``BUILTIN_CODES`` registers each code under the exact filename the reference
database uses, so `--matrix wimax_1152_0.5.alist.txt` works with no database
on disk (see ldpc_tpu_torch.utils.db.resolve_matrix).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np

from ldpc_tpu_torch.models.alist import AlistMatrix

# --------------------------------------------------------------------------
# Base-matrix tables. Cell grammar: '-' = zero block, 'a' = one circulant
# shifted by a, 'a+b' = sum of two circulants (CCSDS). Shifts are given at
# lift size Z0 and expanded to other lifts with floor scaling where the
# family defines it.
# --------------------------------------------------------------------------

# IEEE 802.16e, Table 8.1.1 base matrices at Z0 = 96 (n = 2304).
WIMAX_R12 = """\
  -  94  73   -   -   -   -   -  55  83   -   -   7   0   -   -   -   -   -   -   -   -   -   -
  -  27   -   -   -  22  79   9   -   -   -  12   -   0   0   -   -   -   -   -   -   -   -   -
  -   -   -  24  22  81   -  33   -   -   -   0   -   -   0   0   -   -   -   -   -   -   -   -
 61   -  47   -   -   -   -   -  65  25   -   -   -   -   -   0   0   -   -   -   -   -   -   -
  -   -  39   -   -   -  84   -   -  41  72   -   -   -   -   -   0   0   -   -   -   -   -   -
  -   -   -   -  46  40   -  82   -   -   -  79   0   -   -   -   -   0   0   -   -   -   -   -
  -   -  95  53   -   -   -   -   -  14  18   -   -   -   -   -   -   -   0   0   -   -   -   -
  -  11  73   -   -   -   2   -   -  47   -   -   -   -   -   -   -   -   -   0   0   -   -   -
 12   -   -   -  83  24   -  43   -   -   -  51   -   -   -   -   -   -   -   -   0   0   -   -
  -   -   -   -   -  94   -  59   -   -  70  72   -   -   -   -   -   -   -   -   -   0   0   -
  -   -   7  65   -   -   -   -  39  49   -   -   -   -   -   -   -   -   -   -   -   -   0   0
 43   -   -   -   -  66   -  41   -   -   -  26   7   -   -   -   -   -   -   -   -   -   -   0
"""

WIMAX_R23B = """\
  2   -  19   -  47   -  48   -  36   -  82   -  47   -  15   -  95   0   -   -   -   -   -   -
  -  69   -  88   -  33   -   3   -  16   -  37   -  40   -  48   -   0   0   -   -   -   -   -
 10   -  86   -  62   -  28   -  85   -  16   -  34   -  73   -   -   -   0   0   -   -   -   -
  -  28   -  32   -  81   -  27   -  88   -   5   -  56   -  37   -   -   -   0   0   -   -   -
 23   -  29   -  15   -  30   -  66   -  24   -  50   -  62   -   -   -   -   -   0   0   -   -
  -  30   -  65   -  54   -  14   -   0   -  30   -  74   -   0   -   -   -   -   -   0   0   -
 32   -   0   -  15   -  56   -  85   -   5   -   6   -  52   -   0   -   -   -   -   -   0   0
  -   0   -  47   -  13   -  61   -  84   -  55   -  78   -  41  95   -   -   -   -   -   -   0
"""

WIMAX_R34A = """\
  6  38   3  93   -   -   -  30  70   -  86   -  37  38   4  11   -  46  48   0   -   -   -   -
 62  94  19  84   -  92  78   -  15   -   -  92   -  45  24  32  30   -   -   0   0   -   -   -
 71   -  55   -  12  66  45  79   -  78   -   -  10   -  22  55  70  82   -   -   0   0   -   -
 38  61   -  66   9  73  47  64   -  39  61  43   -   -   -   -  95  32   0   -   -   0   0   -
  -   -   -   -  32  52  55  80  95  22   6  51  24  90  44  20   -   -   -   -   -   -   0   0
  -  63  31  88  20   -   -   -   6  40  56  16  71  53   -   -  27  26  48   -   -   -   -   0
"""

WIMAX_R34B = """\
  -  81   -  28   -   -  14  25  17   -   -  85  29  52  78  95  22  92   0   0   -   -   -   -
 42   -  14  68  32   -   -   -   -  70  43  11  36  40  33  57  38  24   -   0   0   -   -   -
  -   -  20   -   -  63  39   -  70  67   -  38   4  72  47  29  60   5  80   -   0   0   -   -
 64   2   -   -  63   -   -   3  51   -  81  15  94   9  85  36  14  19   -   -   -   0   0   -
  -  53  60  80   -  26  75   -   -   -   -  86  77   1   3  72  60  25   -   -   -   -   0   0
 77   -   -   -  15  28   -  35   -  72  30  68  85  84  26  64  11  89   0   -   -   -   -   0
"""

WIMAX_R56 = """\
  1  25  55   -  47   4   -  91  84   8  86  52  82  33   5   0  36  20   4  77  80   0   -   -
  -   6   -  36  40  47  12  79  47   -  41  21  12  71  14  72   0  44  49   0   0   0   0   -
 51  81  83   4  67   -  21   -  31  24  91  61  81   9  86  78  60  88  67  15   -   -   0   0
 50   -  50  15   -  36  13  10  11  20  53  90  29  92  57  30  84  92  11  66  80   -   -   0
"""

# IEEE 802.22 WRAN rate-5/6 at Z0 = 20 (the other WRAN tables are the WiMAX
# base matrices floor-scaled to Z = 16 / 20).
WRAN_480_R56 = """\
  0   0   0   -   0   0   -   0   0   0   0   0   0   0   0   0   0   0   0   0   0   0   -   -
  -   3   -   0   0   5   0  13   9   -  18  17   8   7   4   1  19  15  10   6   2  14   0   -
 13   8  11   1  16   -   4   -   0   3  18   4   5   6   7  15  12  17  19   1   -   -  12   0
 15   -   9  18   -   2   7   4  13   7   6  16   0  12  14  16   1  11  10  19   8   -   -   0
"""

# ITU-T G.hn (G.9960), n = 336, Z0 = 14.
ITU_GH_336 = """\
  -   -   -   6   -   -   9   6   -   -   2   -   -   0   -   -   -   -   -   -   -   -   -   -
  -   0   -   -   -   3   -  12   1   -   -   3   -   0   0   -   -   -   -   -   -   -   -   -
  -   9  11   -   -  13   -   -   2  12   -   -   -   -   0   0   -   -   -   -   -   -   -   -
  1   -   -  11   -   -   7   -   -   -  11   -   -   -   -   0   0   -   -   -   -   -   -   -
  -   -   -   4   8   -   -   -   -   -   2   5   4   -   -   -   0   0   -   -   -   -   -   -
  -   3   0   -   -   8   -   -   1   -   -   -   -   -   -   -   -   0   0   -   -   -   -   -
  -   -   -   0   6   -   -   -   -   5  13   -   -   -   -   -   -   -   0   0   -   -   -   -
  -   -   -   9   -   -   -   3   -   -   3   1   -   -   -   -   -   -   -   0   0   -   -   -
  9   0  13   -   -  12   -   -   8   -   -   -   -   -   -   -   -   -   -   -   0   0   -   -
  -   5   -   -   1   4   -   -   5   -   -   -   -   -   -   -   -   -   -   -   -   0   0   -
  -   -   -   8   -   -   8   -   -   9   0   -   0   -   -   -   -   -   -   -   -   -   0   0
 10  11   -   -   -   3   -   -   0   -   -   -   4   8   -   -   -   -   -   -   -   -   -   0
"""

# IEEE 802.11n rate-5/6, n = 648, Z0 = 27.
WIFI_648_R56 = """\
 17  13   8  21   9   3  18  12  10   0   4  15  19   2   5  10  26  19  13  13   1   0   -   -
  3  12  11  14  11  25   5  18   0   9   2  26  26  10  24   7  14  20   4   2   -   0   0   -
 22  16   4   3  10  21  12   5  21  14  19   5   -   8   5  18  11   5   5  15   0   -   0   0
  7   7  14  14   4  16  16  24  24  10   1   7  15   6  10  26   8  18  21  14   1   -   -   0
"""

# IEEE 802.11ad (WiGig), n = 672, Z0 = 42.
WIGIG_R12 = """\
 40   -  38   -  13   -   5   -  18   -   -   -   -   -   -   -
 34   -  35   -  27   -   -  30   2   1   -   -   -   -   -   -
  -  36   -  31   -   7   -  34   -  10  41   -   -   -   -   -
  -  27   -  18   -  12  20   -   -   -  15   6   -   -   -   -
 35   -  41   -  40   -  39   -  28   -   -   3  28   -   -   -
 29   -   0   -   -  22   -   4   -  28   -  27   -  23   -   -
  -  31   -  23   -  21   -  20   -   -  12   -   -   0  13   -
  -  22   -  34  31   -  14   -   4   -   -   -  13   -  22  24
"""

WIGIG_R58 = """\
 20  36  34  31  20   7  41  34   -  10  41   -   -   -   -   -
 30  27   -  18   -  12  20  14   2  25  15   6   -   -   -   -
 35   -  41   -  40   -  39   -  28   -   -   3  28   -   -   -
 29   -   0   -   -  22   -   4   -  28   -  27  24  23   -   -
  -  31   -  23   -  21   -  20   -   9  12   -   -   0  13   -
  -  22   -  34  31   -  14   -   4   -   -   -   -   -  22  24
"""

WIGIG_R34 = """\
 35  19  41  22  40  41  39   6  28  18  17   3  28   -   -   -
 29  30   0   8  33  22  17   4  27  28  20  27  24  23   -   -
 37  31  18  23  11  21   6  20  32   9  12  29   -   0  13   -
 25  22   4  34  31   3  14  15   4   -  14  18  13  13  22  24
"""

WIGIG_R1316 = """\
 29  30   0   8  33  22  17   4  27  28  20  27  24  23   -   -
 37  31  18  23  11  21   6  20  32   9  12  29  10   0  13   -
 25  22   4  34  31   3  14  15   4   2  14  18  13  13  22  24
"""

# CCSDS short block codes: 4x8 protograph, weight-2 circulant blocks.
CCSDS_N32 = """\
2+3   1   0   2   0   3   -   0
  0 0+1   0   0   0   0   0   -
  3   0 0+2   0   -   0   1   0
  2   0   0 0+3   0   -   0   0
"""

CCSDS_N128 = """\
0+7   2  14   6   -   0  13   0
  6 0+15   0   1   0   -   0   7
  4   1 0+15  14  11   0   -   3
  0   1   9 0+13  14   1   0   -
"""

CCSDS_N256 = """\
0+31  15  25   0   -  20  12   0
 28 0+30  29  24   0   -   1  20
  8   0 0+28   1  29   0   -  21
 18  30   0 0+30  25  26   0   -
"""

CCSDS_N512 = """\
0+63  30  50  25   -  43  62   0
 56 0+61  50  23   0   -  37  26
 16   0 0+55  27  56   0   -  43
 35  56  62 0+11  58   3   0   -
"""

# "wimax-like" custom sets: rate-1/2 structure, independent shifts per Z.
WIMAXLIKE_P8 = """\
  -   0   0   -   -   -   -   -   0   0   -   -   0   0   -   -   -   -   -   -   -   -   -   -
  -   6   -   -   -   0   0   0   -   -   -   0   -   0   0   -   -   -   -   -   -   -   -   -
  -   -   -   0   0   7   -   2   -   -   -   6   -   -   0   0   -   -   -   -   -   -   -   -
  0   -   5   -   -   -   -   -   4   6   -   -   -   -   -   0   0   -   -   -   -   -   -   -
  -   -   4   -   -   -   1   -   -   0   0   -   -   -   -   -   0   0   -   -   -   -   -   -
  -   -   -   -   5   2   -   0   -   -   -   6   2   -   -   -   -   0   0   -   -   -   -   -
  -   -   6   1   -   -   -   -   -   1   3   -   -   -   -   -   -   -   0   0   -   -   -   -
  -   3   2   -   -   -   6   -   -   0   -   -   -   -   -   -   -   -   -   0   0   -   -   -
  1   -   -   -   3   1   -   0   -   -   -   2   -   -   -   -   -   -   -   -   0   0   -   -
  -   -   -   -   -   5   -   2   -   -   7   7   -   -   -   -   -   -   -   -   -   0   0   -
  -   -   6   7   -   -   -   -   2   0   -   -   -   -   -   -   -   -   -   -   -   -   0   0
  4   -   -   -   -   3   -   7   -   -   -   6   7   -   -   -   -   -   -   -   -   -   -   0
"""

WIMAXLIKE_P10 = """\
  -   0   0   -   -   -   -   -   0   0   -   -   0   0   -   -   -   -   -   -   -   -   -   -
  -   6   -   -   -   0   0   0   -   -   -   0   -   0   0   -   -   -   -   -   -   -   -   -
  -   -   -   0   0   7   -   1   -   -   -   5   -   -   0   0   -   -   -   -   -   -   -   -
  0   -   4   -   -   -   -   -   2   9   -   -   -   -   -   0   0   -   -   -   -   -   -   -
  -   -   6   -   -   -   7   -   -   0   0   -   -   -   -   -   0   0   -   -   -   -   -   -
  -   -   -   -   1   7   -   5   -   -   -   4   8   -   -   -   -   0   0   -   -   -   -   -
  -   -   2   3   -   -   -   -   -   3   9   -   -   -   -   -   -   -   0   0   -   -   -   -
  -   8   9   -   -   -   4   -   -   1   -   -   -   -   -   -   -   -   -   0   0   -   -   -
  1   -   -   -   5   3   -   0   -   -   -   7   -   -   -   -   -   -   -   -   0   0   -   -
  -   -   -   -   -   6   -   1   -   -   2   2   -   -   -   -   -   -   -   -   -   0   0   -
  -   -   1   4   -   -   -   -   8   9   -   -   -   -   -   -   -   -   -   -   -   -   0   0
  7   -   -   -   -   0   -   3   -   -   -   5   2   -   -   -   -   -   -   -   -   -   -   0
"""

WIMAXLIKE_P14 = """\
  -   0   0   -   -   -   -   -   0   0   -   -   0   0   -   -   -   -   -   -   -   -   -   -
  -  13   -   -   -   0   0   0   -   -   -   0   -   0   0   -   -   -   -   -   -   -   -   -
  -   -   -   0   0  10   -   1   -   -   -   8   -   -   0   0   -   -   -   -   -   -   -   -
  0   -   3   -   -   -   -   -  12   4   -   -   -   -   -   0   0   -   -   -   -   -   -   -
  -   -  13   -   -   -  11   -   -   9   0   -   -   -   -   -   0   0   -   -   -   -   -   -
  -   -   -   -   9  13   -  12   -   -   -   0   4   -   -   -   -   0   0   -   -   -   -   -
  -   -   9   7   -   -   -   -   -   8   5   -   -   -   -   -   -   -   0   0   -   -   -   -
  -  11  13   -   -   -   8   -   -   2   -   -   -   -   -   -   -   -   -   0   0   -   -   -
  1   -   -   -   5   5   -   7   -   -   -   4   -   -   -   -   -   -   -   -   0   0   -   -
  -   -   -   -   -  11   -  12   -   -   7   1   -   -   -   -   -   -   -   -   -   0   0   -
  -   -   7   6   -   -   -   -  12   5   -   -   -   -   -   -   -   -   -   -   -   -   0   0
  9   -   -   -   -   0   -   3   -   -   -   2  10   -   -   -   -   -   -   -   -   -   -   0
"""

WIMAXLIKE_P16 = """\
  -   0   0   -   -   -   -   -   0   0   -   -   0   0   -   -   -   -   -   -   -   -   -   -
  -   7   -   -   -   0   0   0   -   -   -   0   -   0   0   -   -   -   -   -   -   -   -   -
  -   -   -   0   0  14   -   1   -   -   -   5   -   -   0   0   -   -   -   -   -   -   -   -
  0   -   3   -   -   -   -   -   4   1   -   -   -   -   -   0   0   -   -   -   -   -   -   -
  -   -  15   -   -   -   7   -   -   2   0   -   -   -   -   -   0   0   -   -   -   -   -   -
  -   -   -   -  10  13   -   6   -   -   -   9  12   -   -   -   -   0   0   -   -   -   -   -
  -   -   9   3   -   -   -   -   -   5  13   -   -   -   -   -   -   -   0   0   -   -   -   -
  -   6   8   -   -   -   2   -   -   0   -   -   -   -   -   -   -   -   -   0   0   -   -   -
  1   -   -   -  12   7   -   4   -   -   -   5   -   -   -   -   -   -   -   -   0   0   -   -
  -   -   -   -   -   8   -   7   -   -   3   3   -   -   -   -   -   -   -   -   -   0   0   -
  -   -   6   8   -   -   -   -   3   7   -   -   -   -   -   -   -   -   -   -   -   -   0   0
 10   -   -   -   -   2   -  12   -   -   -   6   4   -   -   -   -   -   -   -   -   -   -   0
"""


def parse_base_table(text: str) -> tuple[tuple[tuple[int, ...], ...], ...]:
    """Parse the cell grammar into a [mb][nb] table of shift tuples."""
    rows = []
    for line in text.strip().splitlines():
        cells = []
        for cell in line.split():
            if cell == "-":
                cells.append(())
            else:
                cells.append(tuple(int(x) for x in cell.split("+")))
        rows.append(tuple(cells))
    widths = {len(r) for r in rows}
    if len(widths) != 1:
        raise ValueError(f"Ragged base table: row widths {sorted(widths)}")
    return tuple(rows)


def expand_base(
    table, Z: int, Z0: int | None = None
) -> AlistMatrix:
    """Expand a base shift table into H at lift size ``Z``.

    When ``Z0`` is given, shifts scale as ``floor(p * Z / Z0)`` (the 802.16e
    rule); otherwise shifts are used as-is and must lie in [0, Z).
    """
    mb = len(table)
    nb = len(table[0])
    rows: list[np.ndarray] = []
    cols: list[np.ndarray] = []
    r = np.arange(Z, dtype=np.int32)
    for bi in range(mb):
        for bj in range(nb):
            shifts = table[bi][bj]
            scaled = sorted(
                {p * Z // Z0 for p in shifts} if Z0 else set(shifts)
            )
            if len(scaled) != len(shifts):
                raise ValueError(
                    f"Block ({bi},{bj}) shifts {shifts} collide at Z={Z}"
                )
            for s in scaled:
                if not 0 <= s < Z:
                    raise ValueError(f"Shift {s} out of range for Z={Z}")
                rows.append(bi * Z + r)
                cols.append(bj * Z + (r + s) % Z)
    row_idx = np.concatenate(rows)
    col_idx = np.concatenate(cols)
    order = np.lexsort((col_idx, row_idx))
    return AlistMatrix(
        n=nb * Z, m=mb * Z,
        row_idx=row_idx[order].astype(np.int32),
        col_idx=col_idx[order].astype(np.int32),
    )


# --------------------------------------------------------------------- WiMAX

_WIMAX_TABLES = {
    "1/2": WIMAX_R12,
    "2/3B": WIMAX_R23B,
    "3/4A": WIMAX_R34A,
    "3/4B": WIMAX_R34B,
    "5/6": WIMAX_R56,
}
WIMAX_RATES = tuple(_WIMAX_TABLES)
WIMAX_LENGTHS = tuple(range(576, 2305, 96))  # Z = 24 .. 96 step 4


def wimax(n: int, rate: str = "1/2") -> AlistMatrix:
    """IEEE 802.16e WiMAX LDPC code; ``n`` in 576..2304 step 96."""
    if rate not in _WIMAX_TABLES:
        raise ValueError(f"WiMAX rate {rate!r} not in {WIMAX_RATES}")
    if n % 24:
        raise ValueError(f"WiMAX n must be a multiple of 24, got {n}")
    return expand_base(parse_base_table(_WIMAX_TABLES[rate]), Z=n // 24, Z0=96)


# ---------------------------------------------------------------------- WRAN

_WRAN_RATE_ALIAS = {"1/2": "1/2", "2/3": "2/3B", "3/4": "3/4A"}


def wran(n: int, rate: str = "1/2") -> AlistMatrix:
    """IEEE 802.22 WRAN LDPC code; ``n`` in {384, 480}, rates 1/2..5/6."""
    if n not in (384, 480):
        raise ValueError(f"WRAN n must be 384 or 480, got {n}")
    Z = n // 24
    if rate == "5/6" and Z == 20:
        return expand_base(parse_base_table(WRAN_480_R56), Z=20)
    table = _WIMAX_TABLES["5/6" if rate == "5/6" else _WRAN_RATE_ALIAS[rate]]
    return expand_base(parse_base_table(table), Z=Z, Z0=96)


# -------------------------------------------------------------------_others


def wifi_648_r56() -> AlistMatrix:
    """IEEE 802.11n rate-5/6 (648, 540)."""
    return expand_base(parse_base_table(WIFI_648_R56), Z=27)


_WIGIG_TABLES = {
    "1/2": WIGIG_R12,
    "5/8": WIGIG_R58,
    "3/4": WIGIG_R34,
    "13/16": WIGIG_R1316,
}


def wigig(rate: str = "1/2") -> AlistMatrix:
    """IEEE 802.11ad (WiGig) n=672, Z=42; rates 1/2, 5/8, 3/4, 13/16."""
    if rate not in _WIGIG_TABLES:
        raise ValueError(f"WiGig rate {rate!r} not in {tuple(_WIGIG_TABLES)}")
    return expand_base(parse_base_table(_WIGIG_TABLES[rate]), Z=42)


_CCSDS_TABLES = {32: CCSDS_N32, 128: CCSDS_N128, 256: CCSDS_N256, 512: CCSDS_N512}


def ccsds(n: int) -> AlistMatrix:
    """CCSDS short block code (rate 1/2); ``n`` in {32, 128, 256, 512}."""
    if n not in _CCSDS_TABLES:
        raise ValueError(f"CCSDS n must be one of {tuple(_CCSDS_TABLES)}")
    return expand_base(parse_base_table(_CCSDS_TABLES[n]), Z=n // 8)


def itu_gh_336() -> AlistMatrix:
    """ITU-T G.hn (G.9960) n=336 rate-1/2 code (Z=14)."""
    return expand_base(parse_base_table(ITU_GH_336), Z=14)


def tanner_155() -> AlistMatrix:
    """Tanner's algebraic (155, 64) QC code: 3x5 base over Z=31 with
    shift(r, c) = 5^r * 2^c mod 31."""
    table = tuple(
        tuple((pow(5, r, 31) * pow(2, c, 31) % 31,) for c in range(5))
        for r in range(3)
    )
    return expand_base(table, Z=31)


_WIMAXLIKE_TABLES = {8: WIMAXLIKE_P8, 10: WIMAXLIKE_P10, 14: WIMAXLIKE_P14,
                     16: WIMAXLIKE_P16}


def wimaxlike(z: int) -> AlistMatrix:
    """Custom rate-1/2 'wimax-like' sets at Z in {8, 10, 14, 16}."""
    if z not in _WIMAXLIKE_TABLES:
        raise ValueError(f"wimaxlike Z must be one of {tuple(_WIMAXLIKE_TABLES)}")
    return expand_base(parse_base_table(_WIMAXLIKE_TABLES[z]), Z=z)


def bch_7_4() -> AlistMatrix:
    """Cyclic Hamming/BCH (7, 4) parity-check matrix (generator x^3 + x + 1)."""
    H = np.array(
        [
            [1, 0, 1, 1, 1, 0, 0],
            [0, 1, 0, 1, 1, 1, 0],
            [0, 0, 1, 0, 1, 1, 1],
        ],
        dtype=np.uint8,
    )
    rows, cols = np.nonzero(H)
    return AlistMatrix(
        n=7, m=3, row_idx=rows.astype(np.int32), col_idx=cols.astype(np.int32)
    )


# ----------------------------------------------------------------- registry

_WIMAX_RATE_TAG = {"1/2": "0.5", "2/3B": "0.66B", "3/4A": "0.75A",
                   "3/4B": "0.75B", "5/6": "0.83"}


def _builtin_registry() -> dict[str, Callable[[], AlistMatrix]]:
    reg: dict[str, Callable[[], AlistMatrix]] = {}
    for n in WIMAX_LENGTHS:
        for rate, tag in _WIMAX_RATE_TAG.items():
            reg[f"wimax_{n}_{tag}.alist.txt"] = (
                lambda n=n, rate=rate: wimax(n, rate)
            )
    for n in (384, 480):
        z = n // 24
        for rate, rtag, ktag in [("1/2", "05", n // 2), ("2/3", "066", n * 2 // 3),
                                 ("3/4", "075", n * 3 // 4), ("5/6", "083", n * 5 // 6)]:
            reg[f"WRAN_N{n}_K{ktag}_P{z}_R{rtag}.txt"] = (
                lambda n=n, rate=rate: wran(n, rate)
            )
    reg["wifi_648_r083.alist.txt"] = wifi_648_r56
    reg["wigig_R05_N672_K336.alist.txt"] = lambda: wigig("1/2")
    reg["wigig_R063_N672_K420.alist.txt"] = lambda: wigig("5/8")
    reg["wigig_R075_N672_K504.alist.txt"] = lambda: wigig("3/4")
    reg["ieee_802_11ad_p42_n672_r081.alist.txt"] = lambda: wigig("13/16")
    for n in (32, 128, 256, 512):
        reg[f"CCSDS_ldpc_n{n}_k{n // 2}.alist.txt"] = lambda n=n: ccsds(n)
    reg["LDPC_N336_K196_ITU_G.h.alist.txt"] = itu_gh_336
    reg["Tanner_155_64.alist.txt"] = tanner_155
    for z in (8, 10, 14, 16):
        reg[f"wimaxlike_N{24 * z}_K{12 * z}_P{z}_set0.txt"] = (
            lambda z=z: wimaxlike(z)
        )
    reg["BCH_7_4_1_strip.alist.txt"] = bch_7_4
    return reg


BUILTIN_CODES = _builtin_registry()


def builtin_names() -> list[str]:
    return sorted(BUILTIN_CODES)


def is_builtin(name: str) -> bool:
    return _normalize(name) in BUILTIN_CODES


def _normalize(name: str) -> str:
    if name.startswith("builtin:"):
        name = name[len("builtin:"):]
    import os

    return os.path.basename(name)


@lru_cache(maxsize=64)
def make_builtin(name: str) -> AlistMatrix:
    """Construct a built-in code by its canonical (reference DB) filename."""
    key = _normalize(name)
    if key not in BUILTIN_CODES:
        raise KeyError(f"Unknown built-in code: {name!r}")
    return BUILTIN_CODES[key]()
