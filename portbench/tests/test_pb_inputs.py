"""The generator makes, seed for seed, the inputs it made before hosts
and channels were found by name: hashes of each cell's stream, cut
starts and batches (the single-clip pool's cuts and request order), at
the cells' own streams with 3 clips in 2 batches (a pool of 3 cuts),
taken on the tree before that move, on two hosts with two numpy builds
(2.0.2; 2.3.5, the card's host).  The same digests came out of the
tree after the move on both."""
from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from portbench import gen, harness
from portbench.tests.pb_fixtures import two_threads  # noqa: F401

# by the numpy build they were taken with: the v2 transmitter's float
# arithmetic differs between builds, the compat frames and every integer
# draw do not
PINNED = {
    "2.0.2": {
        "compat.batch-clean:2147495993":
            ("2f1452c2e8e88a7c", "a5fb00b074322d25",
             "674a900a8ae6d1cf"),
        "compat.batch-clean:7":
            ("91072292ab788c5d", "64f3c305086a1b9e",
             "c27a6411e2701158"),
        "v2.batch-clean:2147495993":
            ("452faa8ab6f7134c", "fdd34f125a00ab8c",
             "e681904a181b7f74"),
        "v2.batch-clean:7":
            ("c2801c510af73a80", "dfa89ede0b8d254d",
             "c0f2b3bb26de823f"),
        "v2.batch-mp3:2147495993":
            ("ac8db18caeae5c39", "fdd34f125a00ab8c",
             "439279699e7add84"),
        "v2.batch-mp3:7":
            ("b08496723ec92870", "dfa89ede0b8d254d",
             "5119ba1d7a9e4bac"),
        "compat.single-clip:2147495993":
            ("2f1452c2e8e88a7c", "7b278a7ec6f3305a",
             "cc000ba009f611e6"),
        "compat.single-clip:7":
            ("91072292ab788c5d", "eaf7b3d65aea4b66",
             "81d87b7cdf689878"),
    },
    "2.3.5": {
        "compat.batch-clean:2147495993":
            ("2f1452c2e8e88a7c", "a5fb00b074322d25",
             "674a900a8ae6d1cf"),
        "compat.batch-clean:7":
            ("91072292ab788c5d", "64f3c305086a1b9e",
             "c27a6411e2701158"),
        "v2.batch-clean:2147495993":
            ("5da5916ae8051cb7", "fdd34f125a00ab8c",
             "ccdfaa24524260cb"),
        "v2.batch-clean:7":
            ("c4d320cd962de1a7", "dfa89ede0b8d254d",
             "ce0d8ed58d387de9"),
        "v2.batch-mp3:2147495993":
            ("370cb89e0c45be64", "fdd34f125a00ab8c",
             "b2340fbae6d83ffc"),
        "v2.batch-mp3:7":
            ("f9bf60a363d0ad7b", "dfa89ede0b8d254d",
             "c0f6d6495fc4b2a8"),
        "compat.single-clip:2147495993":
            ("2f1452c2e8e88a7c", "7b278a7ec6f3305a",
             "cc000ba009f611e6"),
        "compat.single-clip:7":
            ("91072292ab788c5d", "eaf7b3d65aea4b66",
             "81d87b7cdf689878"),
    },
}


def _sha(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes)
                 else np.ascontiguousarray(p).tobytes())
    return h.hexdigest()[:16]


def digests(name: str, seed: int) -> tuple[str, str, str]:
    """(stream, starts, batches) of cell ``name`` at ``seed``."""
    if name == "compat.single-clip":
        cfg = harness.load_cell("compat.batch-clean")["config"]
        tr = json.loads((harness.PKG / "traffic" / "single-clip.json")
                        .read_text())
        s, cuts, order = gen.make_cuts(cfg, dict(tr, pool=3), seed)
        return (_sha(s.samples, s.nonce, np.int64(s.span)),
                _sha(np.asarray([c.start for c in cuts], np.int64),
                     order.astype(np.int64)),
                _sha(*[c.audio for c in cuts]))
    cell = harness.load_cell(name)
    s, bs = gen.make_batches(cell["config"],
                             dict(cell["traffic"], clips=3, batches=2),
                             seed, "cpu")
    return (_sha(s.samples, s.nonce, np.int64(s.span)),
            _sha(*[np.asarray(b.starts, np.int64) for b in bs]),
            _sha(*[x for b in bs for x in (b.clips.numpy(), b.n_valid.numpy(),
                                            np.float64(b.seconds))]))


@pytest.mark.parametrize("key", sorted(PINNED["2.0.2"]))
def test_inputs_as_before(key):
    name, seed = key.split(":")
    got = digests(name, int(seed))
    pinned = {build: pins[key] for build, pins in PINNED.items()}
    assert {p[1] for p in pinned.values()} == {got[1]}     # the cut starts
    if np.__version__ in pinned:
        assert got == pinned[np.__version__]
    else:
        assert got in pinned.values(), (
            f"numpy {np.__version__} is not among {sorted(pinned)}: take "
            "its digests on the parent tree of the change and pin them")
