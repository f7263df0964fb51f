"""95th percentile of the latency of every request completed in the window:
from its submit to the moment the device finished the step that wrote its
output (a CUDA event after that step)."""
import numpy as np


def read(obs):
    lat = obs["latencies_ms"]
    return float(np.percentile(lat, 95)) if lat else None
