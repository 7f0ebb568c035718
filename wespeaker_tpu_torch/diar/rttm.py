"""RTTM IO: subsegment labels -> merged segments -> RTTM lines, oracle SAD,
and a python DER scorer. Host code, a copy of wespeaker_tpu/diar/rttm.py.

Behavioral spec: wespeaker/diar/make_rttm.py:33-86 (merge same-label
contiguous subsegments, split conflicts at the midpoint) and
wespeaker/diar/make_oracle_sad.py (RTTM -> merged speech segments). The
reference scores DER with SCTK md-eval.pl; here a frame-based DER with
collar and optimal speaker mapping (Hungarian) is provided.
"""

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

RTTM_LINE = "SPEAKER {} {} {:.3f} {:.3f} <NA> <NA> {} <NA> <NA>"


def read_labels(labels_file, frame_shift=10):
    utt_to_subseg_labels = OrderedDict()
    with open(labels_file) as f:
        for line in f:
            subseg, label = line.split()
            utt, begin_ms, end_ms, begin_frames, end_frames = \
                subseg.rsplit("-", 4)
            begin = (int(begin_ms) + int(begin_frames) * frame_shift) / 1000.0
            end = (int(begin_ms) + int(end_frames) * frame_shift) / 1000.0
            utt_to_subseg_labels.setdefault(utt, []).append(
                (begin, end, label))
    return utt_to_subseg_labels


def merge_segments(utt_to_subseg_labels):
    """Merge contiguous same-label subsegments; midpoint-split conflicts."""
    merged = []
    for utt, segs in utt_to_subseg_labels.items():
        if not segs:
            continue
        begin, end, label = segs[0]
        e = end
        for (b, e, lab) in segs[1:]:
            if b <= end and lab == label:
                end = e
            elif b > end:
                merged.append((utt, begin, end, label))
                begin, end, label = b, e, lab
            else:  # overlap with different label: split at midpoint
                pivot = (b + end) / 2.0
                merged.append((utt, begin, pivot, label))
                begin, end, label = pivot, e, lab
        merged.append((utt, begin, e, label))
    return merged


def write_rttm(merged, fout, channel=1):
    for (utt, begin, end, label) in merged:
        print(RTTM_LINE.format(utt, channel, begin, end - begin, label),
              file=fout)


def read_rttm(path) -> Dict[str, List[Tuple[float, float, str]]]:
    out: Dict[str, List[Tuple[float, float, str]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            utt, begin, dur, spk = parts[1], float(parts[3]), \
                float(parts[4]), parts[7]
            out.setdefault(utt, []).append((begin, begin + dur, spk))
    return out


def oracle_sad(rttm_path, min_duration=0.255) -> Dict[str, List[Tuple[float, float]]]:
    """RTTM -> merged speech segments per utterance
    (wespeaker/diar/make_oracle_sad.py:50)."""
    out = {}
    for utt, segs in read_rttm(rttm_path).items():
        ivs = sorted((b, e) for b, e, _ in segs)
        merged = []
        for b, e in ivs:
            if merged and b <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((b, e))
        out[utt] = [(b, e) for b, e in merged if e - b >= min_duration]
    return out


def _scored_intervals(ref_segs, hyp_segs, collar):
    """Elementary scored intervals for one recording: the timeline cut at
    every ref/hyp boundary and collar-zone edge, with md-eval's no-score
    zones (ref boundary +- collar) removed. Yields (duration, active ref
    speaker ids, active hyp speaker ids)."""
    cuts = set()
    noscore = []
    for b, e, _ in ref_segs:
        cuts.update((b, e))
        for t in (b, e):
            noscore.append((t - collar, t + collar))
            cuts.update((t - collar, t + collar))
    for b, e, _ in hyp_segs:
        cuts.update((b, e))
    times = sorted(cuts)
    noscore.sort()
    for t0, t1 in zip(times[:-1], times[1:]):
        if t1 - t0 <= 0:
            continue
        mid = (t0 + t1) / 2.0
        if any(lo < mid < hi for lo, hi in noscore):
            continue
        rs = frozenset(i for i, (b, e, _) in enumerate(ref_segs)
                       if b < mid < e)
        hs = frozenset(i for i, (b, e, _) in enumerate(hyp_segs)
                       if b < mid < e)
        yield t1 - t0, rs, hs


def compute_der(ref: Dict[str, List[Tuple[float, float, str]]],
                hyp: Dict[str, List[Tuple[float, float, str]]],
                collar: float = 0.25) -> float:
    """Diarization error rate with md-eval.pl scoring semantics
    (the reference scores with `md-eval.pl -c 0.25`,
    examples/voxconverse/v2/run.sh:170-173):

      - exact interval arithmetic (event-boundary sweep, no frame
        quantization),
      - no-score collar around every *reference* segment boundary,
      - overlapping speech fully scored: per instant the error is
        max(Nref, Nhyp) - Ncorrect and the denominator counts Nref
        speakers (no `-1` flag, matching the recipe invocation),
      - one optimal one-to-one speaker mapping per recording, maximizing
        mapped overlap time over the scored regions (Hungarian),
      - a single time-weighted DER accumulated across recordings.

    Validated against hand-computed md-eval arithmetic in
    tests/test_der_mdeval.py. Known delta vs md-eval.pl: the speaker map
    here is computed over scored time only (md-eval may weigh collar time
    too when choosing its map; this differs only in near-tie cases where
    two mappings have almost equal overlap).
    """
    from scipy.optimize import linear_sum_assignment

    total_err, total_ref = 0.0, 0.0
    for utt, ref_segs in ref.items():
        hyp_segs = hyp.get(utt, [])
        ref_spks = sorted({s for _, _, s in ref_segs})
        hyp_spks = sorted({s for _, _, s in hyp_segs})
        rmap = {i: ref_spks.index(s)
                for i, (_, _, s) in enumerate(ref_segs)}
        hmap = {i: hyp_spks.index(s)
                for i, (_, _, s) in enumerate(hyp_segs)}
        spans = list(_scored_intervals(ref_segs, hyp_segs, collar))

        # pass 1: overlap time per (ref spk, hyp spk) -> optimal mapping
        overlap = np.zeros((len(ref_spks), len(hyp_spks)))
        for dur, rs, hs in spans:
            for i in {rmap[i] for i in rs}:
                for j in {hmap[j] for j in hs}:
                    overlap[i, j] += dur
        mapped = {}
        if len(ref_spks) and len(hyp_spks):
            ri, hj = linear_sum_assignment(-overlap)
            mapped = dict(zip(ri, hj))

        # pass 2: error time
        for dur, rs, hs in spans:
            nref = len({rmap[i] for i in rs})
            nhyp = len({hmap[j] for j in hs})
            ncorrect = sum(1 for i in {rmap[i] for i in rs}
                           if i in mapped and mapped[i] in {hmap[j]
                                                           for j in hs})
            total_err += dur * (max(nref, nhyp) - ncorrect)
            total_ref += dur * nref
    return float(total_err / max(total_ref, 1e-12))
