"""Share of the key-switching kernels' bound: the least time of the BConvs,
the rotations' fused automorphism and key inner product, and the b-halves'
automorphisms that the traced stretch's HE ops needed (fhebench/work), over
the device time of BConvU, AutoU∘KS and the multi-permutation there."""
from fhebench.work.model import keyswitch_least_s

KERNELS = ("bconv_kernel", "auto_ks_kernel", "perm_cluster_kernel")


def read(obs):
    seg = obs.get("segment")
    if not seg:
        return None
    dev = sum(s for name, s in seg["kernel_s"].items()
              if any(k in name for k in KERNELS))
    least = keyswitch_least_s(obs["params"], seg["work"], obs["peak"])
    return 100.0 * least / dev if dev > 0 and least > 0 else None
