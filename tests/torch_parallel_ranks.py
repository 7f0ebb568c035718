"""One rank of the port's multi-rank CPU checks (gloo).

    python tests/torch_parallel_ranks.py RANK WORLD PORT WORKDIR

The parent test (tests/test_torch_parallel*.py) starts WORLD such
processes and writes WORKDIR/inputs.pt ({"scenarios": [...], and each
scenario's inputs}); each waits for that file, joins the group at
localhost:PORT, runs the scenarios in order and writes
WORKDIR/out_<RANK>.pt ({scenario: results}). This file
imports the port only, never JAX: the parent computes the JAX side.
"""

import contextlib
import copy
import os
import socket
import subprocess
import sys
import time
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from wespeaker_tpu_torch.frontend.fbank import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN  # noqa: E402
from wespeaker_tpu_torch.models.projections import (  # noqa: E402
    ArcMarginProduct, full_state_dict, shard_rows)
from wespeaker_tpu_torch.parallel import collect  # noqa: E402
from wespeaker_tpu_torch.parallel.mesh import (init_distributed,  # noqa
                                               make_mesh)
from wespeaker_tpu_torch.train.optim import make_optimizer  # noqa: E402
from wespeaker_tpu_torch.train.train_step import (AugConfig,  # noqa: E402
                                                  make_train_step)
from wespeaker_tpu_torch.utils import schedulers  # noqa: E402


RANKS_TIMEOUT = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(workdir, inputs, world=2):
    """The parent's side: write inputs, run `world` rank processes of this
    file to their end, return each rank's results."""
    ranks = Ranks(workdir, world)
    ranks.give(inputs)
    return ranks.wait()


class Ranks:
    """`world` rank processes of this file, started at once: they import
    the port while the parent prepares their inputs (give), then run;
    wait() runs them to their end and returns each rank's results."""

    def __init__(self, workdir, world=2):
        self.workdir, self.world = workdir, world
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
        port = _free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             str(port), workdir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def give(self, inputs):
        path = os.path.join(self.workdir, "inputs.pt")
        torch.save(inputs, path + ".tmp")
        os.replace(path + ".tmp", path)

    def wait(self):
        """Each rank's results; the ranks are stopped if given nothing."""
        if not os.path.exists(os.path.join(self.workdir, "inputs.pt")):
            for p in self.procs:
                p.kill()
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=RANKS_TIMEOUT)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(self.procs):
            assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
        return [torch.load(os.path.join(self.workdir, f"out_{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def _cpu(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


def collectives(inp, mesh):
    """The evaluation collectives on this rank's rows of `emb`."""
    n = len(inp["emb"]) // mesh.world
    rows = torch.from_numpy(inp["emb"][mesh.rank * n:(mesh.rank + 1) * n])
    mean, std = collect.sharded_cohort_stats(
        rows, torch.from_numpy(inp["cohort"]), inp["top_n"],
        mesh.data_group)
    return {"gathered": collect.all_gather_embeddings(rows,
                                                      mesh.data_group),
            "mean": mean, "std": std,
            "affinity": collect.sharded_affinity(rows, mesh.data_group)}


def _ecapa_step(inp, mesh, rows, global_stats=True):
    """One ECAPA + ArcMargin step from the parent's weights on `rows` of
    the global batch; the model's state, the whole head and the metrics."""
    c = inp["conf"]
    model = ECAPA_TDNN(c["C"], c["FEAT"], c["EMB"], global_context_att=True,
                       fused=False)
    model.load_state_dict(inp["model"], strict=True)
    head = ArcMarginProduct(c["EMB"], inp["head"].shape[0])
    with torch.no_grad():
        head.weight.copy_(inp["head"])
    shard_rows(head, mesh.model_group)
    opt = make_optimizer(c["opt"], list(model.parameters())
                         + list(head.parameters()))
    step = make_train_step(
        model, head, opt, schedulers.ExponentialDecrease(**c["lr"]),
        schedulers.MarginScheduler(**c["margin"]),
        FbankConfig(num_mel_bins=c["FEAT"], dither=0.0),
        AugConfig(spec_aug=False), device="cpu", mesh=mesh,
        global_stats=global_stats)
    batch = {k: v[rows] for k, v in inp["batch"].items()}
    m = step(batch)
    return {"loss": float(m["loss"]), "acc": float(m["acc"]),
            "model": _cpu(model.state_dict()),
            "head": _cpu(full_state_dict(head))}


def ecapa(inp, mesh):
    """Each data rank's slice of the global batch, with the global
    statistics and with each rank's own."""
    b = len(inp["batch"]["label"]) // mesh.data
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    return {"global": _ecapa_step(inp, mesh, rows),
            "per_rank": _ecapa_step(inp, mesh, rows, global_stats=False)}


def ecapa_model_axis(inp, mesh):
    """Model 2: both ranks step the whole batch with half the head."""
    return _ecapa_step(inp, mesh, slice(None))


@contextlib.contextmanager
def counted_writes():
    """The base names of the checkpoints this rank writes meanwhile."""
    from wespeaker_tpu_torch.utils import checkpoint as ckpt
    writes = []
    save = ckpt.save_checkpoint

    def counted(path, *a, **kw):
        writes.append(os.path.basename(path))
        return save(path, *a, **kw)

    ckpt.save_checkpoint = counted
    try:
        yield writes
    finally:
        ckpt.save_checkpoint = save


def _train(inp, mesh, *overrides):
    from wespeaker_tpu_torch.bin import train as train_cli
    dist_args = (f"distributed_args={{coordinator: {inp['coordinator']}, "
                 f"num_processes: {mesh.world}, process_id: {mesh.rank}}}")
    return train_cli.train(inp["config"], [dist_args, *overrides],
                           device="cpu")


def trainer(inp, mesh):
    """bin/train.py with distributed_args: one epoch, a resume with
    nothing left to run, and one more epoch; which ranks wrote files."""
    ckpt = f"checkpoint={inp['exp_dir']}/models/model_0.pt"
    with counted_writes() as writes:
        step = _train(inp, mesh)
        resumed = _train(inp, mesh, ckpt)
        again = _train(inp, mesh, ckpt, "num_epochs=2")
    return {"steps": step.step, "resumed_steps": resumed.step,
            "resumed": _cpu(resumed.model.state_dict()),
            "again_steps": again.step, "again": _cpu(again.model.state_dict()),
            "writes": writes}


def trainer_once(inp, mesh):
    """One bin/train.py run (its parallel_args from the config); which
    ranks wrote files and the model at its end."""
    with counted_writes() as writes:
        step = _train(inp, mesh)
    return {"writes": writes, "steps": step.step,
            "again": _cpu(step.model.state_dict())}


def preempt(inp, mesh):
    """bin/train.py's SIGTERM poll over the ranks: rank 1's event is set
    before its third poll; -> this rank's answers to five polls."""
    import threading

    from wespeaker_tpu_torch.bin.train import _any_rank
    event = threading.Event()
    answers = []
    with _any_rank(event, mesh) as poll:
        for i in range(5):
            if mesh.rank == 1 and i == 2:
                event.set()
            answers.append(poll())
    return answers


def build_ssl(method, seed, mesh=None):
    """The SSL steps of tests/test_torch_parallel_ssl.py: a narrow ECAPA
    (C=32, feat 24, embed 16) built from `seed`, and for DINO a BN head;
    the same on every rank and in the parent's one-process step."""
    from wespeaker_tpu_torch.ssl import contrastive as C
    from wespeaker_tpu_torch.ssl import dino as D
    torch.manual_seed(seed)
    encoder = ECAPA_TDNN(32, 24, 16, global_context_att=True, fused=False)
    if method == "dino":
        head = D.DINOHead(16, 64, use_bn=True, hidden_dim=32,
                          bottleneck_dim=16)
        state = D.init_dino_state(encoder, head, lambda m: torch.optim.SGD(
            [p for p in m.parameters() if p.requires_grad], lr=0.0,
            momentum=0.9), torch.device("cpu"))
        return D.DINOTrainStep(
            state, D.cosine_scheduler(0.05, 0.01, 3, 1, 1),
            D.cosine_scheduler(0.9, 1.0, 3, 1),
            D.teacher_temp_schedule(0.04, 0.07, 5, 1),
            D.DINOConfig(out_dim=64, n_global=2, n_local=2,
                         freeze_last_layer_iters=0, clip_grad=0.05),
            mesh=mesh)
    opt = torch.optim.SGD(encoder.parameters(), lr=0.0, momentum=0.9)
    lr = D.cosine_scheduler(0.005, 0.001, 3, 1)
    if method == "moco":
        queue = C.l2norm(torch.randn(
            (8, 16), generator=torch.Generator().manual_seed(seed + 1)))
        return C.MoCoTrainStep(encoder, opt, lr, queue, m=0.9, mesh=mesh)
    return C.SimCLRTrainStep(encoder, opt, lr, mesh=mesh)


def ssl_state(step):
    """What a step leaves behind: modules, centre or queue, the loss."""
    out = {}
    for name in ("student", "teacher", "encoder", "key_encoder"):
        if hasattr(step, name):
            out[name] = _cpu(getattr(step, name).state_dict())
    for name in ("center", "queue"):
        if hasattr(step, name):
            out[name] = getattr(step, name).detach().clone()
    if hasattr(step, "queue_ptr"):
        out["queue_ptr"] = step.queue_ptr
    return out


def ssl(inp, mesh):
    """One step of each method on this rank's rows."""
    out = {}
    for method in ("dino", "moco", "simclr"):
        step = build_ssl(method, inp["seed"], mesh)
        m = step(inp[method][mesh.rank])
        out[method] = {"loss": float(m["loss"]), **ssl_state(step)}
    return out


SCENARIOS = {"collectives": (collectives, 1),
             "ecapa": (ecapa, 1),
             "ecapa_model_axis": (ecapa_model_axis, 2),
             "trainer": (trainer, 1),
             "trainer_model_axis": (trainer_once, 1),
             "preempt": (preempt, 1),
             "ssl": (ssl, 1)}


def main(rank, world, port, workdir):
    torch.set_num_threads(1)
    path = os.path.join(workdir, "inputs.pt")
    deadline = time.time() + RANKS_TIMEOUT
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    inputs = torch.load(path, weights_only=False)
    init_distributed(f"localhost:{port}", world, rank, device="cpu")
    results = {}
    for name in inputs["scenarios"]:
        fn, model = SCENARIOS[name]
        mesh = make_mesh(model)
        torch.manual_seed(0)
        results[name] = fn(copy.deepcopy(inputs[name]), mesh)
    torch.save(results, os.path.join(workdir, f"out_{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
             sys.argv[4])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
