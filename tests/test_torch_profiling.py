"""utils/profiling.py on torch.profiler, on the CPU: the FLOP and byte
count of a matrix product (the port's own count, held to the closed form
and to XLA's count of the same product), a trace written by `trace`, the
refusal to time on the CPU, and the trainer's `profile_args` window
written as a Chrome trace. sol_report's timing needs the card (a `cuda`
test)."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from wespeaker_tpu_torch.bin import train as train_cli
from wespeaker_tpu_torch.data.wav_io import write_wav
from wespeaker_tpu_torch.utils import profiling

torch.set_num_threads(2)
M, K, N = 128, 256, 96


def test_cost_analysis_counts_a_matmul_as_jax_does():
    a, b = torch.ones(M, K), torch.ones(K, N)
    costs = profiling.cost_analysis(lambda x, y: x @ y, a, b)
    assert costs["flops"] == 2 * M * N * K
    assert costs["bytes_accessed"] == 4 * (M * K + K * N + M * N)
    jax = pytest.importorskip("jax")
    from wespeaker_tpu.utils.profiling import cost_analysis as j_cost
    want = j_cost(lambda x, y: x @ y, jax.numpy.ones((M, K)),
                  jax.numpy.ones((K, N)))
    assert costs["flops"] == want["flops"]


def test_trace_writes_a_chrome_trace_and_sol_report_needs_the_card(
        tmp_path):
    with profiling.trace(str(tmp_path / "t"), "mm"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "mm.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    with pytest.raises(ValueError, match="card"):
        profiling.sol_report(lambda x: x @ x, torch.ones(8, 8), iters=1)


def _corpus(root, n_spk=3, n_utt=2):
    rng = np.random.default_rng(0)
    lines, u2s = [], []
    for s in range(n_spk):
        for u in range(n_utt):
            key = f"spk{s}-utt{u}"
            path = os.path.join(root, f"{key}.wav")
            write_wav(path, rng.uniform(-0.3, 0.3, int(
                rng.uniform(0.9, 1.6) * 16000)).astype(np.float32), 16000)
            lines.append(json.dumps({"key": key, "wav": path,
                                     "spk": f"spk{s}"}))
            u2s.append(f"{key} spk{s}")
    for name, rows in (("raw.list", lines), ("utt2spk", u2s)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    return os.path.join(root, "raw.list"), os.path.join(root, "utt2spk")


def test_profile_args_trace_the_step_window_on_the_cpu(tmp_path):
    """Steps [1, 6) asked for, three steps run: the window opens before
    step 1 and closes when the loop ends, after step 2."""
    raw, utt2spk = _corpus(str(tmp_path))
    conf = tmp_path / "conf.yaml"
    conf.write_text(yaml.safe_dump({
        "exp_dir": str(tmp_path / "exp"), "train_data": raw,
        "utt2spk": utt2spk, "data_type": "raw", "num_epochs": 1,
        "log_batch_interval": 1, "model": "ECAPA_TDNN",
        "model_args": {"channels": 32, "feat_dim": 24, "embed_dim": 16},
        "dataset_args": {"batch_size": 2, "num_frms": 40,
                         "fbank_args": {"num_mel_bins": 24},
                         "filter_args": {"min_num_frames": 20}},
        "profile_args": {"start_step": 1, "num_steps": 5}}))
    step = train_cli.train(str(conf), device="cpu")
    assert step.step == 3
    files = os.listdir(tmp_path / "exp" / "profile")
    assert files == ["steps_1-3.json"]
    events = json.loads((tmp_path / "exp" / "profile" / files[0])
                        .read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::convolution" in names and "aten::addmm" in names


@pytest.mark.cuda
def test_sol_report_times_a_matmul_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.ones(1024, 1024, device="cuda", dtype=torch.bfloat16)
    rep = profiling.sol_report(lambda x: x @ x, a, iters=5)
    assert rep["seconds_per_call"] > 0
    assert 0 < rep["sol_compute_fraction"] < 1
    assert rep["device"] == torch.cuda.get_device_name(0)
