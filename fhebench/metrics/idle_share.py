"""Share of the traced stretch in which no kernel ran on the card:
1 − the union of kernel intervals over the stretch."""


def read(obs):
    seg = obs.get("segment")
    if not seg or seg["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - seg["busy_s"] / seg["span_s"])
