"""Share of the NTT kernels' bound: the least time of the NTT work that the
traced stretch's HE ops needed (fhebench/work), over the device time of the
NTT kernels there."""
from fhebench.work.model import ntt_least_s

KERNELS = ("ntt_fwd_kernel", "ntt_inv_kernel")


def read(obs):
    seg = obs.get("segment")
    if not seg:
        return None
    dev = sum(s for name, s in seg["kernel_s"].items()
              if any(k in name for k in KERNELS))
    least = ntt_least_s(obs["params"], seg["work"], obs["peak"])
    return 100.0 * least / dev if dev > 0 and least > 0 else None
