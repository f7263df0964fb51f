"""Paper workloads (§VI-B): Boot, ResNet-20, Sort, HELR.

Each has a *virtual* trace generator that replays the HE-op control flow at
paper-scale parameters (N=2^16, L=48), recording primitive-function counts —
the input the NoP/compute cost model consumes (the analogue of the paper's
simulator input).  The port of ``repro.workloads``; the bootstrap runs for
real in :mod:`repro_torch.core.bootstrap`.
"""
