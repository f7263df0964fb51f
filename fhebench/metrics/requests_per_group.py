"""Requests a dispatch carries: the serving engine's ops executed over its
groups dispatched, from the first timed submit until the window drained."""


def read(obs):
    return obs["ops"] / obs["groups"] if obs["groups"] else None
