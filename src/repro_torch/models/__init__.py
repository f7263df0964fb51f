"""LM substrate: the assigned architectures as selectable configs, and the
decoder of the dense and vlm families (``transformer``) on PyTorch."""
