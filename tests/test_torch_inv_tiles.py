"""The bf16 Gemini stage kernel's tile plan (`ops.inv_bottleneck.stage_plan`),
on the CPU.

- The plan covers every output position of a (F, T) plane exactly once, at
  Gemini_DF_ResNet114's four full-width stage shapes and at the edges the
  card tests take (F = 1, T = 1, T' = 49, T not a multiple of the tile,
  F = 3 at C = 32, C = 256 at F = 5 and T = 7), and fits the kernel: its
  outputs in the project's M-blocks, its halo in the expand's, a TMA box of
  at most 256 a dimension, at most 232,448 bytes of shared memory.
- A tile-by-tile emulation in plain torch of what the kernel computes (the
  plan's tiles, an x tile with a one-position halo and zero fill, h zeroed
  at every halo position outside the map, 4C in the plan's chunks, the
  project accumulated over the chunks) matches JAX's
  `inv_bottleneck_stage_reference` in f32 at rtol/atol 1e-5 (the same
  arithmetic, sums in another order), at C = 32 and 64, with the plan's
  tiles and with small tiles forced through `max_out` / `max_halo` so that
  tiles meet inside the map and carry F halo rows. With the zeroing left
  out, it differs at the edges.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.ops import inv_bottleneck_pallas as jinv  # noqa: E402
from wespeaker_tpu_torch.ops import inv_bottleneck as tinv  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)

# (F, T, C): the four stages at 200 frames, and the edges
FULL_WIDTH = [(40, 200, 32), (20, 100, 64), (10, 100, 128), (5, 100, 256)]
EDGES = [(1, 200, 32), (40, 1, 32), (20, 1, 64), (5, 1, 256), (20, 49, 64),
         (10, 49, 128), (5, 49, 256), (40, 98, 32), (10, 149, 128),
         (3, 37, 32), (5, 7, 256), (40, 198, 32), (5, 99, 256), (1, 1, 128)]


def plan_tiles(f, t, plan):
    """The (f0, t0) origins of the plan's output tiles over one (F, T)
    plane, as the kernel numbers its CTAs (T fastest); a tile covers
    [f0, f0 + fo) x [t0, t0 + to) clipped to the map."""
    return [(f0, t0) for f0 in range(0, f, plan.fo)
            for t0 in range(0, t, plan.to)]


@pytest.mark.parametrize("f,t,c", FULL_WIDTH + EDGES)
def test_plan_covers_each_position_once_and_fits(f, t, c):
    plan = tinv.stage_plan(f, t, c)
    cfg = tinv.STAGE_CONFIGS[c]
    hits = np.zeros((f, t), np.int64)
    for f0, t0 in plan_tiles(f, t, plan):
        hits[f0:f0 + plan.fo, t0:t0 + plan.to] += 1
    assert (hits == 1).all()
    fh, th = plan.fo + 2 * plan.fhalo, plan.to + 2
    assert plan.fo * plan.to <= 64 * cfg.mo
    assert fh * th <= 64 * cfg.me
    assert fh <= 256 and th <= 256
    assert plan.fhalo == (plan.fo < f)
    assert plan.chunk == cfg.chunk and (4 * c) % plan.chunk == 0
    assert plan.smem == tinv.stage_smem(c, fh * th, th) <= 232448


def test_full_width_tiles_are_whole_f_columns():
    """At the four full-width shapes a tile spans all of F (no F halo
    rows to recompute) and 10 or 12 frames."""
    for f, t, c in FULL_WIDTH:
        plan = tinv.stage_plan(f, t, c)
        assert (plan.fo, plan.fhalo) == (f, 0) and plan.to in (10, 12), (
            f, t, c, plan)


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="C in"):
        tinv.stage_plan(10, 100, 96)
    with pytest.raises(ValueError, match="empty"):
        tinv.stage_plan(0, 100, 32)


def emulate(x, w, plan, zero_outside=True):
    """The kernel's arithmetic tile by tile, in f32: x (B, F, T, C); w the
    stacked weights (numpy); returns (B, F, T, C)."""
    b, f, t, c = x.shape
    fo, to, fhalo, nc = plan.fo, plan.to, plan.fhalo, plan.chunk
    fh, th = fo + 2 * fhalo, to + 2
    tw = {k: torch.as_tensor(v) for k, v in w.items()}
    cur = x
    for i in range(w["w1"].shape[0]):
        nxt = torch.empty_like(cur)
        for f0, t0 in plan_tiles(f, t, plan):
            fx, tx = f0 - fhalo, t0 - 1
            # the x tile as TMA loads it: zeros beyond the map
            xt = torch.zeros(b, fh, th, c)
            ff = torch.arange(fx, fx + fh)
            tq = torch.arange(tx, tx + th)
            fin = (ff >= 0) & (ff < f)
            tin = (tq >= 0) & (tq < t)
            xt[:, fin[:, None] & tin[None], :] = cur[
                :, ff[fin][:, None], tq[tin][None]].reshape(b, -1, c)
            live = (fin[:, None] & tin[None]).float()[None, :, :, None]
            acc = torch.zeros(b, fo, to, c)
            for c0 in range(0, 4 * c, nc):
                sl = slice(c0, c0 + nc)
                h = torch.relu(xt @ tw["w1"][i][:, sl] * tw["s1"][i][sl]
                               + tw["t1"][i][sl])
                if zero_outside:
                    h = h * live
                # rows beyond the halo tile (fhalo = 0) read as zeros
                hp = torch.nn.functional.pad(
                    h, (0, 0, 0, 0, 1 - fhalo, 1 - fhalo))
                y = torch.zeros(b, fo, to, nc)
                for df in range(3):
                    for dt in range(3):
                        y = y + (hp[:, df:df + fo, dt:dt + to]
                                 * tw["wdw"][i][df, dt, sl])
                g = torch.relu(y * tw["s2"][i][sl] + tw["t2"][i][sl])
                acc = acc + g @ tw["w2"][i][sl]
            res = xt[:, fhalo:fhalo + fo, 1:1 + to]
            o = torch.relu(acc * tw["s3"][i] + tw["t3"][i] + res)
            nf, nt = min(fo, f - f0), min(to, t - t0)
            nxt[:, f0:f0 + nf, t0:t0 + nt] = o[:, :nf, :nt]
        cur = nxt
    return cur


def _case(c, f, t):
    rng = np.random.default_rng(1000 * c + 10 * f + t)

    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    L, d = 2, 4 * c
    w = dict(w1=r(L, c, d, s=c ** -0.5), s1=1 + r(L, d, s=.1),
             t1=r(L, d, s=.1), wdw=r(L, 3, 3, d, s=1 / 3),
             s2=1 + r(L, d, s=.1), t2=r(L, d, s=.1),
             w2=r(L, d, c, s=d ** -0.5), s3=1 + r(L, c, s=.1),
             t3=r(L, c, s=.1))
    return r(2, f, t, c), w


# (C, F, T, max_out, max_halo): the plan's own tiles (one tile a plane at
# these sizes), then forced small tiles: F split with halo rows, T split
# with a ragged last tile
EMULATED = [(32, 5, 13, None, None), (32, 3, 1, None, None),
            (64, 5, 13, None, None), (64, 3, 1, None, None),
            (32, 5, 13, 6, 24), (64, 5, 13, 8, 40), (64, 3, 1, 2, 9)]


@pytest.mark.parametrize("c,f,t,max_out,max_halo", EMULATED)
def test_tile_emulation_matches_jax_reference(c, f, t, max_out, max_halo):
    x, w = _case(c, f, t)
    plan = tinv.stage_plan(f, t, c, max_out=max_out, max_halo=max_halo)
    if max_out is not None:
        assert len(plan_tiles(f, t, plan)) > 1
    got = emulate(torch.as_tensor(x), w, plan)
    want = np.asarray(jinv.inv_bottleneck_stage_reference(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()}))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c,f,t,max_out,max_halo",
                         [(32, 5, 13, None, None), (64, 5, 13, 8, 40)])
def test_tile_emulation_without_zeroing_differs_at_the_edges(
        c, f, t, max_out, max_halo):
    """h = relu(t1) where TMA's zero fill gave x = 0: not the conv's
    padding. The emulation then misses the reference at the map's edges
    and still matches it inside."""
    x, w = _case(c, f, t)
    plan = tinv.stage_plan(f, t, c, max_out=max_out, max_halo=max_halo)
    got = emulate(torch.as_tensor(x), w, plan, zero_outside=False).numpy()
    want = np.asarray(jinv.inv_bottleneck_stage_reference(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()}))
    assert not np.allclose(got, want, **TOL)
    # after two blocks the error has spread two positions in from the ends
    # of T (and of F where the tile carries F halo rows)
    inner = (slice(None), slice(2, -2) if plan.fhalo else slice(None),
             slice(2, -2))
    if plan.fhalo:
        assert not np.allclose(got[:, :, :2], want[:, :, :2], **TOL)
    np.testing.assert_allclose(got[inner], want[inner], **TOL)
