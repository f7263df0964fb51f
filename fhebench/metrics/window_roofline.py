"""The whole step's share of the card's peak: the least time of all the HE
work dispatched from the first timed submit until the window drained
(fhebench/work), over that time."""
from fhebench.work.model import whole_least_s


def read(obs):
    if "peak" not in obs or obs["loop_s"] <= 0:
        return None
    least = whole_least_s(obs["params"], obs["work"], obs["peak"])
    return 100.0 * least / obs["loop_s"] if least > 0 else None
