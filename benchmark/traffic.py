"""The traffic maker: one generator for every mix, driven by a data file.

A mix (benchmark/traffic/<name>.json) names the endpoint, the closed-loop
clients, the pool of utterances and its phoneme counts, the utterances in
one request, and the daemon's batching and streaming knobs.  From `--seed`
it makes a pool of utterances and, per client, the order in which that
client sends them.

Every seed gets the same work in another order: the pool's phoneme counts
are the same evenly spaced set for every seed (shuffled by it), and each
client walks whole permutations of the pool, so a run's mix of lengths does
not depend on the seed; the phoneme ids, the puncts and the style vectors
do.

This module imports numpy and the standard library only: the load
generator's child process imports it, and that process must not load torch.
"""

from __future__ import annotations

import base64
import json
import struct
from typing import Dict, Iterator, List, NamedTuple

import numpy as np

SEED_MASK = (1 << 64) - 1


class Utterance(NamedTuple):
    phonemes: np.ndarray     # (n,) int32, ids in [1, num_phonemes)
    puncts: np.ndarray       # (n,) int32, in [0, num_puncts]
    style: np.ndarray        # (d_model,) float32


def seed_words(seed: int, *more: int) -> List[int]:
    """A seed (any whole number, negative or beyond 64 bits included) and
    further stream numbers as the words of a numpy SeedSequence."""
    return [int(seed) & SEED_MASK, *(int(m) for m in more)]


def phoneme_counts(mix: dict) -> np.ndarray:
    """The pool's phoneme counts: `pool` values evenly spaced over the mix's
    inclusive range, the same for every seed."""
    lo, hi = mix["phonemes"]
    return np.rint(np.linspace(lo, hi, mix["pool"])).astype(np.int64)


def make_pool(mix: dict, model: dict, seed: int) -> List[Utterance]:
    """The mix's pool of utterances for `seed` (model: the configuration's
    num_phonemes, num_puncts and d_model)."""
    rng = np.random.default_rng(seed_words(seed, 1))
    counts = rng.permutation(phoneme_counts(mix))
    pool = []
    for n in counts:
        ph = rng.integers(1, model["num_phonemes"], size=int(n)).astype(np.int32)
        pu = rng.integers(0, model["num_puncts"] + 1, size=int(n)).astype(np.int32)
        style = rng.normal(0.0, mix["style_std"], size=model["d_model"]).astype(np.float32)
        pool.append(Utterance(ph, pu, style))
    return pool


def client_requests(mix: dict, seed: int, client: int) -> Iterator[List[int]]:
    """The pool indices of a client's requests, one list of
    `utterances_per_request` distinct indices each, without end: consecutive
    slices of seeded permutations of the pool."""
    rng = np.random.default_rng(seed_words(seed, 2, client))
    per = mix["utterances_per_request"]
    perm: List[int] = []
    while True:
        if len(perm) < per:
            perm = perm + rng.permutation(mix["pool"]).tolist()
        yield perm[:per]
        perm = perm[per:]


def sample_key(seed: int, client: int, k: int) -> float:
    """The key that draws the checked sample: the requests of the window
    with the smallest keys are kept (benchmark.loadgen)."""
    return float(np.random.default_rng(seed_words(seed, 3, client, k)).random())


# ------------------------------------------------------------- wire format

BINARY_MAGIC = b"ZVB1"


def utterance_binary(u: Utterance) -> bytes:
    """The daemon's raw-binary utterance body: b"ZVB1", uint32 n, n int32
    phonemes, n int32 puncts, d_model float32 style, all little-endian."""
    ph = np.ascontiguousarray(u.phonemes, dtype="<i4")
    pu = np.ascontiguousarray(u.puncts, dtype="<i4")
    st = np.ascontiguousarray(u.style, dtype="<f4")
    return BINARY_MAGIC + struct.pack("<I", len(ph)) + ph.tobytes() + pu.tobytes() + st.tobytes()


def utterance_json(u: Utterance) -> str:
    """The utterance in the daemon's JSON schema."""
    return json.dumps({"phonemes": u.phonemes.tolist(), "puncts": u.puncts.tolist(),
                       "style": [float(x) for x in u.style]})


def request_body(mix: dict, pool: List[Utterance], idxs: List[int],
                 cache: Dict[int, str]) -> bytes:
    """The body of one request: binary for one utterance where the mix says
    so, else JSON (a /batch request: {"utterances": [...]})."""
    if mix["body"] == "binary":
        return utterance_binary(pool[idxs[0]])
    parts = []
    for i in idxs:
        if i not in cache:
            cache[i] = utterance_json(pool[i])
        parts.append(cache[i])
    if mix["endpoint"] == "/batch":
        return ('{"utterances": [' + ", ".join(parts) + "]}").encode()
    return parts[0].encode()


def content_type(mix: dict) -> str:
    return "application/octet-stream" if mix["body"] == "binary" else "application/json"


# ---------------------------------------------------------------- answers

WAV_HEADER = 44


def pcm_of_wav(wav: bytes) -> bytes:
    """The PCM16 bytes of a 44-byte-header WAV."""
    return wav[WAV_HEADER:]


def batch_pcms(body: bytes) -> List[bytes]:
    """The PCM16 bytes of each WAV of a /batch answer."""
    return [pcm_of_wav(base64.b64decode(w)) for w in json.loads(body)["wavs"]]
