"""DINO, MoCo and SimCLR in two gloo ranks on the CPU against the port's
one-process step on the global batch.

One group of two rank processes (tests/torch_parallel_ranks.py) takes one
step of each method from the same seeded narrow ECAPA (C=32, feat 24,
embed 16; DINO with a BatchNorm head, 2 global and 2 local crops, the
per-tensor clip acting), each rank on its own B=2 rows; the parent takes
the same step in one process on the global B=4 batch (the ranks' rows
view-major: each view's rank 0 rows, then rank 1's). The one-process
steps are held to the JAX package's by tests/test_torch_ssl_*.py. The
loss (the global batch's), every parameter and BatchNorm buffer of the
student and teacher (encoder and key encoder), DINO's centre and MoCo's
queue and pointer agree within 1e-5 (of the largest magnitude where that
exceeds 1); the two ranks end bit-identical. Rank 1's rows are scaled and
shifted, so per-rank BatchNorm statistics would differ.
"""

import os

import numpy as np
import pytest
import torch

from tests.torch_parallel_ranks import (build_ssl, run_ranks,  # noqa
                                        ssl_state)

torch.set_num_threads(2)
B, FEAT, SEED = 2, 24, 11


def _rows(rng, shape, rank):
    x = rng.standard_normal(shape).astype(np.float32)
    return x * 3.0 + 1.0 if rank else x


def _view_major(parts, n_views):
    """Each rank's view-major rows -> the global view-major batch."""
    return np.concatenate([p.reshape(n_views, B, *p.shape[1:])
                           for p in parts], axis=1).reshape(
        -1, *parts[0].shape[1:])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ssl_ranks"))
    rng = np.random.default_rng(SEED)
    batches = {
        "dino": [{"global_feat": _rows(rng, (2 * B, 30, FEAT), r),
                  "local_feat": _rows(rng, (2 * B, 15, FEAT), r)}
                 for r in range(2)],
        "moco": [{k: _rows(rng, (B, 30, FEAT), r)
                  for k in ("q_feat", "k_feat")} for r in range(2)],
        "simclr": [{"feat": _rows(rng, (2 * B, 30, FEAT), r)}
                   for r in range(2)]}
    out = run_ranks(root, {"scenarios": ["ssl"],
                           "ssl": {"seed": SEED, **batches}})
    return batches, [o["ssl"] for o in out]


def _global(method, parts):
    if method == "dino":
        return {k: _view_major([p[k] for p in parts], 2)
                for k in ("global_feat", "local_feat")}
    if method == "moco":
        return {k: np.concatenate([p[k] for p in parts])
                for k in ("q_feat", "k_feat")}
    return {"feat": _view_major([p["feat"] for p in parts], 2)}


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1.0)
    assert err <= 1e-5, f"{what}: {err:.3g}"


@pytest.mark.parametrize("method", ["dino", "moco", "simclr"])
def test_two_rank_ssl_step_is_the_global_step(ranks, method):
    batches, out = ranks
    step = build_ssl(method, SEED)
    m = step(_global(method, batches[method]))
    want = ssl_state(step)
    r0, r1 = out[0][method], out[1][method]
    _close(r0["loss"], float(m["loss"]), "loss")
    assert r0["loss"] == r1["loss"]
    for name, value in want.items():
        if isinstance(value, dict):
            for key, v in value.items():
                if key.endswith("num_batches_tracked"):
                    assert int(r0[name][key]) == int(v), key
                    continue
                _close(r0[name][key], v, f"{name}.{key}")
                assert torch.equal(r0[name][key], r1[name][key]), key
        elif isinstance(value, torch.Tensor):
            _close(r0[name], value, name)
            assert torch.equal(r0[name], r1[name]), name
        else:
            assert r0[name] == r1[name] == value, name
