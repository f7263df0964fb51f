"""Requests completed in the window, per second of the window."""


def read(obs):
    return len(obs["latencies_ms"]) / obs["seconds"]
