"""The one traffic generator: reads a mix from ``fhebench/traffic/<mix>.json``
and makes, from the run's seed, every tenant's keys, its pool of encrypted
requests and its plaintexts, through the program's client API.

A mix file holds data only:

* ``program``: the straight-line HE program, a list of
  ``{"kind", "dst", "srcs", "arg"}``, ``outputs``: the registers returned;
* ``inputs``: per input register, the message: ``slots`` (a count of
  leading slots, or ``"all"``) drawn from ``dist`` (``normal`` N(0, 1), or
  ``uniform`` on [lo, hi)); the rest of the slots are zero;
* ``plaintexts``: per plaintext name, a message as above, one per tenant
  (the tenant's model), encoded at the input level and held in the NTT
  domain, as a server holds its weights;
* ``tenants``, ``clients_per_tenant``: the closed loop's clients, each
  keeping one request outstanding; ``pool_per_tenant``: distinct requests
  per tenant, encrypted once at set-up and resubmitted in turn;
* ``warmup_waves``: waves served before the window;
* ``about``: one line of prose.

Every client keeps one request outstanding (a closed loop); a mix with any
other key is refused, so that a setting nothing reads cannot pass as one.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from fhebench.reference.ckks import encode_scale

STREAM_KEYS, STREAM_MESSAGES, STREAM_ENCRYPT, STREAM_PLAINTEXTS, STREAM_SAMPLE \
    = 1, 2, 3, 4, 5


MIX_KEYS = {"about", "tenants", "clients_per_tenant", "pool_per_tenant",
            "warmup_waves", "inputs", "plaintexts", "program", "outputs"}


def check_mix(traffic: dict) -> None:
    extra = set(traffic) - MIX_KEYS
    if extra:
        raise ValueError(f"unknown keys in the traffic mix: {sorted(extra)}")


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, *stream])


def key_seed(seed: int, tenant: int) -> int:
    return int(np.random.SeedSequence([seed % 2 ** 63, STREAM_KEYS, tenant])
               .generate_state(2, np.uint64)[0] >> 1)


def message(spec: dict, n: int, gen: np.random.Generator) -> np.ndarray:
    """Real slot values of one message (length n, zeros past ``slots``)."""
    k = n if spec.get("slots", "all") == "all" else int(spec["slots"])
    z = np.zeros(n)
    if spec.get("dist", "normal") == "normal":
        z[:k] = gen.normal(size=k)
    elif spec["dist"] == "uniform":
        z[:k] = gen.uniform(spec["lo"], spec["hi"], size=k)
    else:
        raise ValueError(f"unknown message distribution {spec['dist']!r}")
    return z


def rotations(traffic: dict) -> tuple[int, ...]:
    return tuple(sorted({int(op["arg"]) for op in traffic["program"]
                         if op["kind"] == "hrot"}))


@dataclasses.dataclass
class Tenant:
    name: str
    key_seed: int
    keyset: object
    messages: list            # pool entry → {register: slot vector}
    inputs: list              # pool entry → {register: Ciphertext}
    pt_messages: dict         # plaintext name → slot vector
    plaintexts: dict          # plaintext name → (RnsPoly, scale)


def make_tenants(traffic: dict, params, config: dict, seed: int, device,
                 port, times: dict) -> list[Tenant]:
    """Keys, pool and plaintexts of every tenant; ``port`` is the module
    namespace of the program's client API (keys, encoding, poly).  The
    seconds key generation and the pool's encryption took go to ``times``
    (``keys_s``, ``pool_s``)."""
    check_mix(traffic)
    K, enc, pl = port.keys, port.encoding, port.poly
    N, n = params.N, params.N // 2
    ell = config["ell_in"]
    basis = params.q[:ell]
    scale = encode_scale(params.q, ell, params.rescale_primes)
    rots = rotations(traffic)
    tenants = []
    times.update(keys_s=0.0, pool_s=0.0)
    for t in range(traffic["tenants"]):
        ks_seed = key_seed(seed, t)
        t0 = time.perf_counter()
        keyset = K.keygen(params, rotations=rots, seed=ks_seed, device=device)
        t1 = time.perf_counter()
        times["keys_s"] += t1 - t0
        msgs, cts = [], []
        for i in range(traffic["pool_per_tenant"]):
            gen = rng(seed, STREAM_MESSAGES, t, i)
            zs = {r: message(spec, n, gen)
                  for r, spec in traffic["inputs"].items()}
            enc_rng = rng(seed, STREAM_ENCRYPT, t, i)
            cts.append({r: K.encrypt(enc.encode(z, scale, basis, N), scale,
                                     keyset.sk, basis, N, rng=enc_rng,
                                     device=device)
                        for r, z in zs.items()})
            msgs.append(zs)
        times["pool_s"] += time.perf_counter() - t1
        pt_msgs, pts = {}, {}
        for j, (name, spec) in enumerate(sorted(traffic["plaintexts"].items())):
            z = message(spec, n, rng(seed, STREAM_PLAINTEXTS, t, j))
            res = enc.encode(z, scale, basis, N)
            pts[name] = (pl.RnsPoly(pl.to_tensor(res, device), basis,
                                    pl.COEFF).to_ntt(), scale)
            pt_msgs[name] = z
        tenants.append(Tenant(f"tenant{t}", ks_seed, keyset, msgs, cts,
                              pt_msgs, pts))
    return tenants
