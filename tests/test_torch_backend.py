"""Port parity for the scoring back end: the metrics, cosine and AS-Norm
scoring, the score / score_norm / compute_metrics CLIs and checkpoint
averaging, against the JAX package on the CPU.

- Metrics (`backend/metrics.py`, numpy f64 in both packages): the FNR/FPR
  curves, EER and its threshold, minDCF and the DET points equal JAX's to
  the bit on seeded scores, the perfectly separated case (EER 0) too.
- Scoring (`backend/scoring.py`, torch f32 against JAX's jnp f32):
  `cosine_scores`, `cohort_mean_std` (top_n 5 and S-Norm's whole cohort,
  top_n past the cohort clipped), `asnorm_scores` and `TrialScorer.asnorm`
  within 1e-5 (the top-k may break ties by other indices; the top values
  are the same).
- The CLIs on one ark written by the port's kaldi_io: every field of the
  port's `.score` and normalized score files within 1e-5 of JAX's CLIs'
  (keys, order and labels equal), and compute_metrics' printed lines
  equal; `--det_png` without matplotlib raises ImportError.
- average_model: floating tensors the f32 mean of the last `num` epoch
  files, `num_batches_tracked` the last file's.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.backend import metrics as jm  # noqa: E402
from wespeaker_tpu.backend import scoring as js  # noqa: E402
from wespeaker_tpu.bin import compute_metrics as j_cm  # noqa: E402
from wespeaker_tpu.bin import score as j_score  # noqa: E402
from wespeaker_tpu.bin import score_norm as j_norm  # noqa: E402
from wespeaker_tpu_torch.backend import metrics as tm  # noqa: E402
from wespeaker_tpu_torch.backend import scoring as ts  # noqa: E402
from wespeaker_tpu_torch.bin import average_model as t_avg  # noqa: E402
from wespeaker_tpu_torch.bin import compute_metrics as t_cm  # noqa: E402
from wespeaker_tpu_torch.bin import score as t_score  # noqa: E402
from wespeaker_tpu_torch.bin import score_norm as t_norm  # noqa: E402
from wespeaker_tpu_torch.utils.kaldi_io import write_vec_ark_scp  # noqa

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _scores(seed, n=400, separated=False):
    rng = np.random.default_rng(seed)
    labels = (rng.uniform(size=n) < 0.2).astype(np.int64)
    shift = 10.0 if separated else 1.5
    scores = rng.normal(size=n) + shift * labels
    return scores, labels


@pytest.mark.parametrize("separated", [False, True])
def test_metrics_equal_jax_to_the_bit(separated):
    scores, labels = _scores(3, separated=separated)
    fnr, fpr = tm.pmiss_pfa(scores, labels)
    jfnr, jfpr = jm.pmiss_pfa(scores, labels)
    assert np.array_equal(fnr, jfnr) and np.array_equal(fpr, jfpr)
    assert tm.eer(fnr, fpr, scores) == jm.eer(jfnr, jfpr, scores)
    assert tm.min_dcf(fnr, fpr, 0.05) == jm.min_dcf(jfnr, jfpr, 0.05)
    got = tm.compute_metrics(scores, labels, 0.01)
    assert got == jm.compute_metrics(scores, labels, 0.01)
    if separated:
        assert got[0] == 0.0
    for a, b in zip(tm.det_curve_points(fnr, fpr),
                    jm.det_curve_points(jfnr, jfpr)):
        assert np.array_equal(a, b)
    strings = ["target", "nontarget", "tgt", "x"]
    assert np.array_equal(tm.labels_from_strings(strings),
                          jm.labels_from_strings(strings))


def _emb(seed, n, d=24):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_cosine_and_cohort_statistics_match_jax():
    emb, cohort = _emb(0, 9), _emb(1, 30)
    rng = np.random.default_rng(2)
    ei, ti = rng.integers(0, 9, 40), rng.integers(0, 9, 40)
    np.testing.assert_allclose(
        ts.cosine_scores(emb, ei, ti, device="cpu"),
        np.asarray(js.cosine_scores(jnp.asarray(emb), jnp.asarray(ei),
                                    jnp.asarray(ti))), **TOL)
    for top_n in (5, 30, 300):  # asnorm, the whole cohort, clipped
        got = ts.cohort_mean_std(emb, cohort, top_n, device="cpu")
        want = js.cohort_mean_std(emb, cohort, top_n)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, np.asarray(w), **TOL)
    mean, std = ts.cohort_mean_std(emb, cohort, 5, device="cpu")
    raw = rng.normal(size=40)
    np.testing.assert_allclose(
        ts.asnorm_scores(raw, mean, std, mean, std, ei, ti, device="cpu"),
        np.asarray(js.asnorm_scores(raw, mean, std, mean, std, ei, ti)),
        **TOL)


def test_trial_scorer_matches_jax():
    keys = [f"u{i}" for i in range(8)]
    emb = dict(zip(keys, _emb(4, 8)))
    mean_vec = _emb(5, 1)[0] * 0.1
    cohort = _emb(6, 20)
    trials = [(keys[i], keys[j]) for i in range(8) for j in range(i + 1, 8)]
    port = ts.TrialScorer(emb, mean_vec, device="cpu")
    ref = js.TrialScorer(emb, mean_vec)
    raw = port.score_trials(trials)
    assert raw.dtype == np.float32
    np.testing.assert_allclose(raw, ref.score_trials(trials), **TOL)
    got = port.asnorm(trials, raw, cohort, top_n=7)
    want = ref.asnorm(trials, raw, cohort, top_n=7)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


def _fields(path):
    with open(path) as f:
        return [line.split() for line in f]


def _assert_same_lines(got_path, want_path):
    got, want = _fields(got_path), _fields(want_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            try:
                np.testing.assert_allclose(float(a), float(b), **TOL)
            except ValueError:
                assert a == b


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().splitlines()


def test_score_cli_chain_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    spk = np.repeat(np.arange(6), 3)
    centers = _emb(8, 6, d=16)
    keys = [f"s{s}_u{i}" for i, s in enumerate(spk)]
    vecs = centers[spk] + 0.7 * _emb(9, len(keys), d=16)
    write_vec_ark_scp(str(tmp_path / "eval"), zip(keys, vecs))
    cal = tmp_path / "cal"
    write_vec_ark_scp(str(cal / "xvector"), zip(keys[:10], vecs[:10] + 0.3))
    write_vec_ark_scp(str(tmp_path / "cohort"),
                      zip([f"c{i}" for i in range(12)], _emb(10, 12, d=16)))
    lines = []
    for _ in range(60):
        a, b = rng.choice(len(keys), 2, replace=False)
        lines.append(f"{keys[a]} {keys[b]} "
                     + ("target" if spk[a] == spk[b] else "nontarget"))
    trials = tmp_path / "trials"
    trials.write_text("\n".join(lines) + "\n")

    outs = {}
    for name, cli in (("port", t_score), ("jax", j_score)):
        kw = {"device": "cpu"} if name == "port" else {}
        outs[name] = cli.score(str(tmp_path), str(tmp_path / "eval.scp"),
                               str(cal), [str(trials)],
                               store_dir=str(tmp_path / name), **kw)[0]
        # each CLI writes cal/mean_vec.npy; the port's must equal JAX's
        outs[name + "_mean"] = np.load(cal / "mean_vec.npy")
    assert np.array_equal(outs["port_mean"], outs["jax_mean"])
    _assert_same_lines(outs["port"], outs["jax"])
    for method, top_n in (("asnorm", 5), ("snorm", 300)):
        norm = {}
        for name, cli in (("port", t_norm), ("jax", j_norm)):
            kw = {"device": "cpu"} if name == "port" else {}
            norm[name] = cli.score_norm(
                method, top_n, outs["jax"],
                str(tmp_path / f"{name}_{method}.score"),
                str(tmp_path / "cohort.scp"), str(tmp_path / "eval.scp"),
                str(cal / "mean_vec.npy"), **kw)
        _assert_same_lines(norm["port"], norm["jax"])

    got = _printed(t_cm.metrics_for_file, outs["port"])
    want = _printed(j_cm.metrics_for_file, outs["port"])
    assert got == want and got[1].startswith("EER = ")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        t_cm.main(["--det_png", str(tmp_path / "det.png"), outs["port"]])


def test_average_model_takes_the_f32_mean_and_the_last_counters(tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    sds = []
    for epoch in range(4):
        g = torch.Generator().manual_seed(epoch)
        sd = {"w": torch.randn(3, 5, generator=g),
              "bn.running_var": torch.rand(5, generator=g),
              "bn.num_batches_tracked": torch.tensor(10 * (epoch + 1))}
        torch.save({"state_dict": sd, "projection": {"weight": sd["w"]}},
                   models / f"model_{epoch}.pt")
        sds.append(sd)
    torch.save({"state_dict": sds[0]}, models / "final_model.pt")
    dst = str(tmp_path / "avg.pt")
    t_avg.main(["--src_path", str(models), "--dst_model", dst, "--num",
                "3"])
    avg = torch.load(dst, weights_only=True)
    assert set(avg) == set(sds[0])
    for key in ("w", "bn.running_var"):
        want = (sds[1][key] + sds[2][key] + sds[3][key]) / 3
        torch.testing.assert_close(avg[key], want, rtol=1e-6, atol=1e-7)
    assert avg["bn.num_batches_tracked"].item() == 40
    with pytest.raises(FileNotFoundError):
        t_avg.average_model(str(tmp_path), dst)
    assert os.path.exists(dst)
