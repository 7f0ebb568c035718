"""Recipe-local data-prep utilities (the reference's examples/*/local/*.py).

Python equivalents, one CLI, of the per-recipe prep scripts the reference
keeps under examples/cnceleb/v2/local and examples/sre/v{2,3}/local:

- combine        -- choose_utts_to_combine.py: group consecutive short
                    utterances until every group reaches --min-duration,
                    merging within a speaker first, then (optionally)
                    across speakers; combined utts are assigned to the
                    speaker that contributed the most duration.
- combine-audio  -- comb_accd_to_utt2utts.py: materialize the combined
                    utterances by concatenating the source audio files.
- cnceleb-trials -- format_trials_cnceleb.py: eval/lists/{enroll,trials}.lst
                    -> kaldi 'enroll test target|nontarget' trials.
- voice-dur      -- utt2voice_duration.py: sum per-utt VAD speech time.
- filter-dur     -- filter_utt_accd_dur.py: keep wav.scp rows whose voice
                    duration exceeds a threshold.
- aug-copies     -- generate_sre_aug.py: replicate wav.scp/utt2spk/vad rows
                    with _copy-<i> suffixes so each copy draws independent
                    augmentation at train time.
- system-sad     -- sre local/make_system_sad.py: VAD over a wav.scp,
                    emitting 'utt-<bms>-<ems> utt begin end' segment lines.

CLI: python -m wespeaker_tpu_torch.bin.prep_local <cmd> ...

Counterpart of wespeaker_tpu/bin/prep_local.py, file for file. Audio goes
through the port's data/wav_io.py; `system-sad` runs the port's
diar/vad.py::system_sad on the host (a silero torch.jit file's
probabilities with --model-path, the energy VAD otherwise), as the JAX
package's does, so the tool takes no `--device`.
"""

import argparse
import os
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from wespeaker_tpu_torch.data.wav_io import read_wav, write_wav

# Durations in these tools are real seconds, far apart relative to float
# rounding; comparisons use a tolerance so accumulation order can't flip a
# grouping decision (choose_utts_to_combine.py:91-93 'LessThan').
_EPS = 1.0e-5


def _definitely_less(x: float, y: float) -> bool:
    return x < y - _EPS


def combine_spans(durations: Sequence[float],
                  min_duration: float) -> List[Tuple[int, int]]:
    """Group consecutive indexes so each group's total duration reaches
    `min_duration` (when the overall total allows it), returning [start, end)
    spans. Deficient groups merge with a neighbor chosen by the reference's
    rules (choose_utts_to_combine.py:106-208): prefer the side that gets the
    group over the threshold, break ties toward the shorter neighbor so
    group sizes stay even.
    """
    assert min_duration >= 0.0
    n = len(durations)
    if n == 0:
        return []
    assert min(durations) > 0.0
    # rep[j]: start index of the group j currently belongs to. For a group
    # representative r: end[r] is one past its last index, total[r] its
    # summed duration.
    rep = list(range(n))
    end = [i + 1 for i in range(n)]
    total = [float(d) for d in durations]

    # LIFO over deficient group reps, highest index processed first.
    stack = [i for i in range(n) if _definitely_less(total[i], min_duration)]
    while stack:
        i = stack.pop()
        if rep[i] != i or not _definitely_less(total[i], min_duration):
            continue  # merged away, or grew past the threshold meanwhile
        left = total[rep[i - 1]] if i > 0 else 0.0
        right = total[end[i]] if end[i] < n else 0.0
        if left == 0.0 and right == 0.0:
            break  # single group left; nothing to merge with
        if left == 0.0:
            go_left = False
        elif right == 0.0 or _definitely_less(min_duration, right):
            go_left = True
        elif _definitely_less(left + total[i], min_duration):
            go_left = False  # left alone would stay deficient
        elif _definitely_less(right + total[i], min_duration):
            go_left = True  # right alone would stay deficient, left won't
        else:
            # either side satisfies the minimum: absorb the shorter one
            go_left = _definitely_less(left, right)

        if go_left:
            r = rep[i - 1]
            total[r] += total[i]
            for j in range(i, end[i]):
                rep[j] = r
            end[r] = end[i]
            # if the merged group is still deficient, its rep r was already
            # deficient before and therefore already sits on the stack
        else:
            r_right = end[i]
            total[i] += total[r_right]
            for j in range(r_right, end[r_right]):
                rep[j] = i
            end[i] = end[r_right]
            if _definitely_less(total[i], min_duration):
                stack.append(i)

    spans = []
    i = 0
    while i < n:
        spans.append((i, end[i]))
        i = end[i]
    return spans


def group_utterances(spk2utt: Sequence[Tuple[str, Sequence[str]]],
                     utt2dur: Dict[str, float],
                     min_duration: float = 1.55,
                     within_speaker_only: bool = False) -> List[List[str]]:
    """Two passes (choose_utts_to_combine.py:253-310): combine each
    speaker's own utterances, then optionally combine the resulting groups
    across speakers when a whole speaker stayed under the minimum."""
    groups: List[List[str]] = []
    group_durs: List[float] = []
    for spk, utts in spk2utt:
        missing = [u for u in utts if u not in utt2dur]
        if missing:
            raise KeyError(f"no duration for utterance(s) {missing[:3]} "
                           f"of speaker {spk}")
        durs = [utt2dur[u] for u in utts]
        for s, e in combine_spans(durs, min_duration):
            groups.append(list(utts[s:e]))
            group_durs.append(sum(durs[s:e]))
    if within_speaker_only:
        return groups
    merged: List[List[str]] = []
    for s, e in combine_spans(group_durs, min_duration):
        merged.append([u for g in groups[s:e] for u in g])
    return merged


def _group_name(group: Sequence[str]) -> str:
    return group[0] if len(group) == 1 else f"{group[0]}-comb{len(group)}"


def _majority_speaker(group: Sequence[str], utt2spk: Dict[str, str],
                      utt2dur: Dict[str, float]) -> str:
    spks = [utt2spk[u] for u in group]
    if all(s == spks[0] for s in spks):
        return spks[0]
    by_dur: Dict[str, float] = defaultdict(float)
    for u in group:
        by_dur[utt2spk[u]] += utt2dur[u]
    # deterministic: first (sorted) speaker among ties within tolerance
    best, best_dur = None, -1.0
    for spk in sorted(by_dur):
        if _definitely_less(best_dur, by_dur[spk]):
            best, best_dur = spk, by_dur[spk]
    return best


def combine_short_utterances(spk2utt_path: str, utt2dur_path: str,
                             utt2utts_out: str, utt2spk_out: str,
                             utt2dur_out: str, min_duration: float = 1.55,
                             within_speaker_only: bool = False) -> int:
    """File-level driver matching the reference CLI contract: reads
    spk2utt + utt2dur, writes utt2utts / utt2spk / utt2dur for the combined
    utterances. Returns the number of output utterances."""
    spk2utt: List[Tuple[str, List[str]]] = []
    utt2spk: Dict[str, str] = {}
    with open(spk2utt_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(f"bad spk2utt line: {line!r}")
            spk, utts = parts[0], parts[1:]
            for u in utts:
                if u in utt2spk:
                    raise ValueError(f"utterance {u} listed twice in spk2utt")
                utt2spk[u] = spk
            spk2utt.append((spk, utts))
    utt2dur: Dict[str, float] = {}
    with open(utt2dur_path) as f:
        for line in f:
            utt, dur = line.split()
            utt2dur[utt] = float(dur)

    groups = group_utterances(spk2utt, utt2dur, min_duration,
                              within_speaker_only)
    with open(utt2utts_out, "w") as f_utts, \
            open(utt2spk_out, "w") as f_spk, \
            open(utt2dur_out, "w") as f_dur:
        for g in groups:
            name = _group_name(g)
            print(name, " ".join(g), file=f_utts)
            print(name, _majority_speaker(g, utt2spk, utt2dur), file=f_spk)
            print(name, sum(utt2dur[u] for u in g), file=f_dur)
    return len(groups)


def _read_audio_any(path: str) -> Tuple[np.ndarray, int]:
    if path.endswith(".wav"):
        return read_wav(path)
    try:
        import soundfile as sf  # optional; flac etc.
    except ImportError:
        raise RuntimeError(
            f"{path}: only .wav is readable without the optional "
            "'soundfile' package (needed for flac sources)")
    data, sr = sf.read(path, dtype="float32")
    return (data.T if data.ndim > 1 else data), sr


def combine_audio(utt2utts_path: str, src_dir: str, out_dir: str,
                  extension: str = "wav") -> int:
    """Concatenate each group's source files into <out_dir>/<name>.wav
    (comb_accd_to_utt2utts.py semantics; utt ids are relative paths like
    'spk/utt'). Returns the number of files written."""
    n = 0
    with open(utt2utts_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            name, sources = parts[0], parts[1:]
            pieces, sr = [], None
            for u in sources:
                data, this_sr = _read_audio_any(
                    os.path.join(src_dir, f"{u}.{extension}"))
                if data.ndim > 1:
                    data = data[0]
                if sr is not None and this_sr != sr:
                    raise ValueError(f"{name}: sample-rate mismatch "
                                     f"({this_sr} vs {sr})")
                sr = this_sr
                pieces.append(data)
            out_path = os.path.join(out_dir, f"{name}.wav")
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            write_wav(out_path, np.concatenate(pieces), sr)
            n += 1
    return n


def format_trials_cnceleb(cnceleb_root: str, dst_trl_path: str) -> int:
    """eval/lists/enroll.lst (spk -> enroll wav) + trials.lst (spk test 0|1)
    -> 'enroll_path test_path target|nontarget' lines
    (format_trials_cnceleb.py:22-35)."""
    enroll = {}
    with open(os.path.join(cnceleb_root, "eval/lists/enroll.lst")) as f:
        for line in f:
            spk, wav = line.split()
            enroll[spk] = wav
    n = 0
    with open(os.path.join(cnceleb_root, "eval/lists/trials.lst")) as f, \
            open(dst_trl_path, "w") as out:
        for line in f:
            spk, test, label = line.split()
            tag = "target" if label == "1" else "nontarget"
            print(enroll[spk], test, tag, file=out)
            n += 1
    return n


def utt2voice_duration(vad_file: str, out_path: str) -> int:
    """Sum VAD speech seconds per utterance. Accepts both 'seg utt beg end'
    and 'utt beg end' line shapes (utt2voice_duration.py:20-32 keys on the
    last three fields)."""
    totals: Dict[str, float] = {}
    order: List[str] = []
    with open(vad_file) as f:
        for line in f:
            parts = line.split()
            utt, beg, end = parts[-3], float(parts[-2]), float(parts[-1])
            if utt not in totals:
                totals[utt] = 0.0
                order.append(utt)
            totals[utt] += end - beg
    with open(out_path, "w") as f:
        for utt in order:
            print(utt, totals[utt], file=f)
    return len(order)


def filter_by_voice_duration(wav_scp: str, utt2voice_dur: str,
                             out_scp: str, dur_thres: float = 5.0) -> int:
    """Keep wav.scp rows whose summed voice duration strictly exceeds
    dur_thres (filter_utt_accd_dur.py:19-31); rows without a duration are
    dropped."""
    durs: Dict[str, float] = {}
    with open(utt2voice_dur) as f:
        for line in f:
            utt, dur = line.split()
            durs[utt] = float(dur)
    n = 0
    with open(wav_scp) as f, open(out_scp, "w") as out:
        for line in f:
            utt = line.split()[0]
            if durs.get(utt, 0.0) > dur_thres:
                out.write(line)
                n += 1
    return n


def make_aug_copies(ori_dir: str, aug_dir: str, aug_copy_num: int = 2) -> int:
    """Write wav.scp/utt2spk (and vad, when present) with each row repeated
    under utt_copy-<0..N> ids (generate_sre_aug.py:19-55). Copy 0 is the
    original; each copy draws independent augmentation at train time."""
    os.makedirs(aug_dir, exist_ok=True)
    copies = range(aug_copy_num + 1)

    def expand(src: str, dst: str, key_cols: int):
        with open(src) as f, open(dst, "w") as out:
            for line in f:
                parts = line.split()
                keys, rest = parts[:key_cols], " ".join(parts[key_cols:])
                for i in copies:
                    tagged = [f"{k}_copy-{i}" for k in keys]
                    print(*tagged, rest, file=out)

    expand(os.path.join(ori_dir, "wav.scp"),
           os.path.join(aug_dir, "wav.scp"), 1)
    expand(os.path.join(ori_dir, "utt2spk"),
           os.path.join(aug_dir, "utt2spk"), 1)
    vad = os.path.join(ori_dir, "vad")
    if os.path.exists(vad):
        # vad rows are 'seg utt beg end': both ids get the copy suffix
        expand(vad, os.path.join(aug_dir, "vad"), 2)
    n = sum(1 for _ in open(os.path.join(aug_dir, "wav.scp")))
    return n


def system_sad_scp(wav_scp: str, out_path: str, min_duration: float = 0.0,
                   model_path: Optional[str] = None, threshold: float = 0.25,
                   out=None) -> int:
    """VAD over every wav.scp entry, writing the sre recipes' segment-table
    shape 'utt-<beg_ms:08d>-<end_ms:08d> utt beg end'
    (sre/v2/local/make_system_sad.py:108-119). The probability model is a
    silero torch.jit file when given, else the energy fallback."""
    from wespeaker_tpu_torch.diar.vad import system_sad

    close_out = False
    if out is None:
        out = sys.stdout if out_path == "-" else open(out_path, "w")
        close_out = out is not sys.stdout
    n = 0
    try:
        with open(wav_scp) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                utt, wav_path = parts[0], " ".join(parts[1:])
                wav, sr = read_wav(wav_path)
                if wav.ndim > 1:
                    wav = wav[0]
                for beg, end in system_sad(wav, sr, model_path=model_path,
                                           threshold=threshold,
                                           min_duration=min_duration):
                    print(f"{utt}-{int(beg * 1000):08d}-{int(end * 1000):08d}"
                          f" {utt} {beg:.3f} {end:.3f}", file=out)
                    n += 1
    finally:
        if close_out:
            out.close()
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("combine", help="choose_utts_to_combine.py")
    c.add_argument("spk2utt")
    c.add_argument("utt2dur")
    c.add_argument("utt2utts_out")
    c.add_argument("utt2spk_out")
    c.add_argument("utt2dur_out")
    c.add_argument("--min-duration", type=float, default=1.55)
    c.add_argument("--merge-within-speakers-only", action="store_true")

    a = sub.add_parser("combine-audio", help="comb_accd_to_utt2utts.py")
    a.add_argument("utt2utts")
    a.add_argument("src_dir")
    a.add_argument("out_dir")
    a.add_argument("--extension", default="wav")

    t = sub.add_parser("cnceleb-trials", help="format_trials_cnceleb.py")
    t.add_argument("--cnceleb_root", required=True)
    t.add_argument("--dst_trl_path", required=True)

    v = sub.add_parser("voice-dur", help="utt2voice_duration.py")
    v.add_argument("vad_file")
    v.add_argument("out")

    fd = sub.add_parser("filter-dur", help="filter_utt_accd_dur.py")
    fd.add_argument("wav_scp")
    fd.add_argument("utt2voice_dur")
    fd.add_argument("out_scp")
    fd.add_argument("--dur-thres", type=float, default=5.0)

    g = sub.add_parser("aug-copies", help="generate_sre_aug.py")
    g.add_argument("ori_dir")
    g.add_argument("aug_dir")
    g.add_argument("--aug-copy-num", type=int, default=2)

    s = sub.add_parser("system-sad", help="sre local/make_system_sad.py")
    s.add_argument("wav_scp")
    s.add_argument("out", help="'-' for stdout")
    s.add_argument("--min-duration", type=float, default=0.0)
    s.add_argument("--model-path", default=None,
                   help="silero torch.jit weights (energy VAD otherwise)")
    s.add_argument("--threshold", type=float, default=0.25)

    args = p.parse_args(argv)
    if args.cmd == "combine":
        n = combine_short_utterances(
            args.spk2utt, args.utt2dur, args.utt2utts_out, args.utt2spk_out,
            args.utt2dur_out, min_duration=args.min_duration,
            within_speaker_only=args.merge_within_speakers_only)
        print(f"combined into {n} utterances", file=sys.stderr)
    elif args.cmd == "combine-audio":
        n = combine_audio(args.utt2utts, args.src_dir, args.out_dir,
                          extension=args.extension)
        print(f"wrote {n} combined files", file=sys.stderr)
    elif args.cmd == "cnceleb-trials":
        n = format_trials_cnceleb(args.cnceleb_root, args.dst_trl_path)
        print(f"wrote {n} trials", file=sys.stderr)
    elif args.cmd == "voice-dur":
        n = utt2voice_duration(args.vad_file, args.out)
        print(f"{n} utterances", file=sys.stderr)
    elif args.cmd == "filter-dur":
        n = filter_by_voice_duration(args.wav_scp, args.utt2voice_dur,
                                     args.out_scp, dur_thres=args.dur_thres)
        print(f"kept {n} rows", file=sys.stderr)
    elif args.cmd == "aug-copies":
        n = make_aug_copies(args.ori_dir, args.aug_dir,
                            aug_copy_num=args.aug_copy_num)
        print(f"{n} aug rows", file=sys.stderr)
    elif args.cmd == "system-sad":
        n = system_sad_scp(args.wav_scp, args.out,
                           min_duration=args.min_duration,
                           model_path=args.model_path,
                           threshold=args.threshold)
        print(f"{n} segments", file=sys.stderr)


if __name__ == "__main__":
    main()
