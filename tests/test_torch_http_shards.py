"""http(s) shards: a shard list of URLs streams through urllib into
tarfile's stream mode, in the port as in the JAX package.

The shards are served from a ThreadingHTTPServer on 127.0.0.1 (loopback,
no network). The port's `parse_shard` over the URLs yields the same
keys, speakers, sample rates and wav arrays as JAX's over the same URLs
and as the port's over the local paths; SpeakerDataset batches from the
URL list equal those from the local list at the same seed, in one
process and through two spawned MPPrefetcher workers; a URL that cannot
be opened (a closed port, a 404) is skipped in both packages. The
trainer's one-thread Prefetcher stops streaming when it is closed, and a
process that closes it exits cleanly.
"""

import functools
import http.server
import io
import os
import socket
import subprocess
import sys
import tarfile
import threading
from collections import Counter

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's data/ needs both

from wespeaker_tpu.data import pipeline as jpipe  # noqa: E402
from wespeaker_tpu_torch.bin import train as train_cli  # noqa: E402
from wespeaker_tpu_torch.data import dataset as tds  # noqa: E402
from wespeaker_tpu_torch.data import pipeline as tpipe  # noqa: E402
from wespeaker_tpu_torch.data.wav_io import write_wav  # noqa: E402

SR = 16000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Quiet(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """3 tar shards of 4 utterances (0.7-1.3 s, PCM16; one shard at 8 kHz)
    under a loopback server; -> the paths, the URLs, utt2spk, spk2id."""
    root = str(tmp_path_factory.mktemp("shards"))
    rng = np.random.default_rng(3)
    paths, u2s = [], []
    for i in range(3):
        path = os.path.join(root, f"shard{i}.tar")
        with tarfile.open(path, "w") as tf:
            for u in range(4):
                key, spk = f"spk{u % 3}-s{i}u{u}", f"spk{u % 3}"
                sr = 8000 if i == 2 else SR
                n = int(rng.uniform(0.7, 1.3) * sr)
                wav = os.path.join(root, "utt.wav")
                write_wav(wav, (rng.uniform(-0.3, 0.3, n) * (1 + u)).astype(
                    np.float32), sr)
                with open(wav, "rb") as f:
                    blob = f.read()
                for name, blob in ((f"{key}.wav", blob),
                                   (f"{key}.spk", spk.encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(blob)
                    tf.addfile(info, io.BytesIO(blob))
                u2s.append(f"{key} {spk}")
        paths.append(path)
    with open(os.path.join(root, "utt2spk"), "w") as f:
        f.write("\n".join(u2s) + "\n")
    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(_Quiet, directory=root))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    lists = {}
    for name, rows in (("local", paths),
                       ("http", [f"{base}/{os.path.basename(p)}"
                                 for p in paths])):
        lists[name] = os.path.join(root, f"{name}.list")
        with open(lists[name], "w") as f:
            f.write("\n".join(rows) + "\n")
    yield {"paths": paths, "base": base, "lists": lists,
           "spk2id": tpipe.spk2id_from_utt2spk(os.path.join(root,
                                                           "utt2spk"))}
    server.shutdown()
    server.server_close()
    thread.join()


def _same_samples(got, want):
    assert [s["key"] for s in got] == [s["key"] for s in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["key", "sample_rate", "spk", "wav"]
        assert g["spk"] == w["spk"] and g["sample_rate"] == w["sample_rate"]
        assert g["wav"].dtype == w["wav"].dtype
        np.testing.assert_array_equal(g["wav"], w["wav"])


def test_url_shards_parse_as_jax_and_as_the_local_files(served):
    urls = tpipe.read_lists(served["lists"]["http"])
    got = list(tpipe.parse_shard(urls))
    assert len(got) == 12 and {s["sample_rate"] for s in got} == {8000, SR}
    _same_samples(got, list(jpipe.parse_shard(urls)))
    _same_samples(got, list(tpipe.parse_shard(served["paths"])))


def test_unreachable_urls_are_skipped_as_jax_skips_them(served):
    with socket.socket() as s:  # a loopback port that nobody serves
        s.bind(("127.0.0.1", 0))
        closed = f"http://127.0.0.1:{s.getsockname()[1]}/shard0.tar"
    urls = [closed, f"{served['base']}/missing.tar",
            f"{served['base']}/shard1.tar", served["paths"][0] + ".gone"]
    got = list(tpipe.parse_shard(urls))
    assert [s["key"] for s in got] == [f"spk{u % 3}-s1u{u}"
                                       for u in range(4)]
    _same_samples(got, list(jpipe.parse_shard(urls)))


CONF = {"num_frms": 50, "shuffle_args": {"shuffle_size": 4},
        "filter_args": {"min_num_frames": 50, "max_num_frames": 150},
        "speed_perturb": True, "aug_prob": 0.0}


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) >= 4
    for g, w in zip(got, want):
        assert g["key"] == w["key"] and sorted(g) == sorted(w)
        for k in g:
            if k != "key":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_speaker_dataset_batches_from_urls_equal_the_local_list(served):
    local, remote = (tds.SpeakerDataset("shard", served["lists"][k], CONF,
                                      served["spk2id"], seed=4)
                   for k in ("local", "http"))
    _same_batches(remote.batches(3, max_epochs=2),
                  local.batches(3, max_epochs=2))


def test_mp_prefetcher_workers_stream_the_urls(served):
    """Two spawned workers over the URL list give the multiset of batches
    that the two stripes of the local list give in one process."""
    want = []
    for w in range(2):
        want += list(tds.SpeakerDataset(
            "shard", served["lists"]["local"], CONF, served["spk2id"],
            seed=4, worker_id=w, num_workers=2).batches(2, max_epochs=2))
    pf = tds.MPPrefetcher(("shard", served["lists"]["http"], CONF,
                           served["spk2id"]), {"seed": 4}, 2,
                          num_workers=2, max_epochs=2)
    got = list(pf)
    assert all(not p.is_alive() for p in pf.procs)

    def multiset(batches):  # the workers' batches interleave in any order
        return Counter((tuple(b["key"]), b["wav"].tobytes(),
                        b["label"].tobytes()) for b in batches)

    assert len(got) == len(want) >= 4
    assert multiset(got) == multiset(want)


def test_prefetcher_close_ends_the_endless_stream(served):
    """close() stops the producer after the item in hand, closes its
    generator (whose shard streams close with it) and joins the thread;
    the trainer's batch context closes its Prefetcher on exit."""
    ds = tds.SpeakerDataset("shard", served["lists"]["http"], CONF,
                            served["spk2id"], seed=4)
    closed = threading.Event()

    def endless():
        try:
            yield from ds.batches(2)
        finally:
            closed.set()

    pf = tds.Prefetcher(endless())
    next(iter(pf))
    pf.close()
    assert not pf.thread.is_alive() and closed.is_set()

    def producers():
        return {t for t in threading.enumerate()
                if t.name.endswith("(worker)")}

    before = producers()
    with train_cli._batches(None, None, ds, 2, {}) as batches:
        next(batches)
        (thread,) = producers() - before
    assert not thread.is_alive()


def test_a_process_that_closes_its_prefetcher_exits_cleanly():
    """A producer thread still inside a torch op when the interpreter
    exits aborts the process ("terminate called without an active
    exception", SIGABRT); once closed, the process exits 0."""
    code = ("import torch\n"
            "from wespeaker_tpu_torch.data.dataset import Prefetcher\n"
            "def endless():\n"
            "    x = torch.randn(256, 4000)\n"
            "    while True:\n"
            "        yield torch.stft(x, 512, return_complex=True).sum()\n"
            "pf = Prefetcher(endless(), depth=1)\n"
            "next(iter(pf))\n"
            "pf.close()\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
