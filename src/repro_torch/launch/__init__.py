"""Entry points: the serving launcher (FHE and LM), the training launcher,
the meshes (FHE, and the LM's over a fake world of ranks) and the dry-run
tools (``dryrun``, ``dryrun_all``, ``dryrun_fhe`` with ``specs``, ``hlo``,
``subproc``)."""


def require_device(device) -> None:
    """Refuse a ``cuda`` device on a machine without a card: the entry
    points never fall back to the CPU."""
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not available")
