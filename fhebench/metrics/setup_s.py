"""Seconds from process start to the first timed submit: the kernels' build
or load, tables, key generation, the pool's encryption and the warm-up."""


def read(obs):
    return obs["setup_s"]
