"""Kernel launches (the program's launch counters) per request, over the
requests submitted in the window, all of which complete by its drain."""


def read(obs):
    return obs["launches"] / obs["requests"] if obs["requests"] and obs["launches"] else None
