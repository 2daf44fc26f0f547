"""Share of the traced stretch (streaming calls, or whole sweeps with their
executor build) in which the card ran nothing, in percent."""


def read(ctx):
    st = ctx.stretch
    if st.window_s <= 0 or st.busy_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
