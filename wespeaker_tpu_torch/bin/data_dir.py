"""Kaldi-style data-directory utilities.

Python equivalents of the reference's shell/perl data-dir tools used by the
recipe layer (tools/utt2spk_to_spk2utt.pl, tools/spk2utt_to_utt2spk.pl,
tools/filter_scp.pl, tools/fix_data_dir.sh, tools/subset_data_dir.sh,
tools/combine_data.sh, tools/copy_data_dir.sh). A "data dir" is a directory
of whitespace-separated tables keyed by utterance id in column 1 (wav.scp,
utt2spk, utt2dur, vad, feats.scp, text, ...) plus the derived spk2utt.

CLI:
    python -m wespeaker_tpu_torch.bin.data_dir <cmd> ...
with cmds: spk2utt, utt2spk, filter, fix, subset, combine, copy.

Counterpart of wespeaker_tpu/bin/data_dir.py: plain Python on the host
(no torch, no `--device`), the same files byte for byte.
"""

import argparse
import os
import shutil
import sys
from typing import Dict, Iterable, List, Optional

# per-utterance tables a data dir may contain (spk2utt is derived and is
# always regenerated from utt2spk by fix/subset/combine/copy)
UTT_TABLES = ("wav.scp", "utt2spk", "utt2dur", "utt2num_frames", "vad",
              "feats.scp", "text", "segments", "utt2lang", "utt2gender")


def read_table(path: str) -> List[List[str]]:
    with open(path) as f:
        return [line.split() for line in f if line.strip()]


def write_table(path: str, rows: Iterable[Iterable[str]]):
    with open(path, "w") as f:
        for row in rows:
            f.write(" ".join(str(c) for c in row) + "\n")


def utt2spk_to_spk2utt(rows: List[List[str]]) -> List[List[str]]:
    """utt2spk rows -> sorted spk2utt rows (tools/utt2spk_to_spk2utt.pl)."""
    spk2utts: Dict[str, List[str]] = {}
    for utt, spk in ((r[0], r[1]) for r in rows):
        spk2utts.setdefault(spk, []).append(utt)
    return [[s] + sorted(us) for s, us in sorted(spk2utts.items())]


def spk2utt_to_utt2spk(rows: List[List[str]]) -> List[List[str]]:
    """spk2utt rows -> sorted utt2spk rows (tools/spk2utt_to_utt2spk.pl)."""
    out = []
    for row in rows:
        spk, utts = row[0], row[1:]
        out.extend([u, spk] for u in utts)
    return sorted(out)


def filter_rows(id_list: Iterable[str], rows: List[List[str]],
                field: int = 1, exclude: bool = False) -> List[List[str]]:
    """Keep rows whose `field`-th (1-based) column is in id_list — the
    reference's tools/filter_scp.pl ([--exclude] [-f N] id_list < in)."""
    ids = set(id_list)
    return [r for r in rows
            if len(r) >= field and (r[field - 1] in ids) != exclude]


def _utt_tables(dirpath: str) -> List[str]:
    return [t for t in UTT_TABLES
            if os.path.isfile(os.path.join(dirpath, t))]


def _regen_spk2utt(dirpath: str):
    u2s = os.path.join(dirpath, "utt2spk")
    if os.path.isfile(u2s):
        write_table(os.path.join(dirpath, "spk2utt"),
                    utt2spk_to_spk2utt(read_table(u2s)))


def fix_data_dir(dirpath: str) -> int:
    """Sort every per-utt table, drop duplicate utt ids, restrict all
    tables to the utt ids present in every table, and regenerate spk2utt
    (tools/fix_data_dir.sh). Returns the surviving utt count."""
    tables = _utt_tables(dirpath)
    if not tables:
        raise FileNotFoundError(f"no data-dir tables in {dirpath}")
    common: Optional[set] = None
    for t in tables:
        ids = {r[0] for r in read_table(os.path.join(dirpath, t))}
        common = ids if common is None else common & ids
    for t in tables:
        rows, seen = [], set()
        for r in sorted(read_table(os.path.join(dirpath, t))):
            if r[0] in common and r[0] not in seen:
                rows.append(r)
                seen.add(r[0])
        write_table(os.path.join(dirpath, t), rows)
    _regen_spk2utt(dirpath)
    return len(common)


def subset_data_dir(src: str, dest: str, utt_list: Optional[str] = None,
                    spk_list: Optional[str] = None,
                    first: Optional[int] = None,
                    last: Optional[int] = None) -> int:
    """Subset a data dir by utt list / spk list / first-or-last N utts
    (tools/subset_data_dir.sh --utt-list/--spk-list/--first/--last)."""
    given = sum(x is not None for x in (utt_list, spk_list, first, last))
    if given != 1:
        raise ValueError("exactly one of utt_list/spk_list/first/last")
    u2s = read_table(os.path.join(src, "utt2spk"))
    if utt_list is not None:
        keep = {r[0] for r in read_table(utt_list)}
    elif spk_list is not None:
        spks = {r[0] for r in read_table(spk_list)}
        keep = {u for u, s in ((r[0], r[1]) for r in u2s) if s in spks}
    else:
        utts = sorted(r[0] for r in u2s)
        keep = set(utts[:first] if first is not None else utts[-last:])
    os.makedirs(dest, exist_ok=True)
    for t in _utt_tables(src):
        write_table(os.path.join(dest, t),
                    filter_rows(keep, read_table(os.path.join(src, t))))
    _regen_spk2utt(dest)
    return len(keep)


def combine_data_dirs(dest: str, srcs: List[str]) -> int:
    """Concatenate data dirs into dest, sorted, failing on duplicate utt
    ids (tools/combine_data.sh). Only tables present in EVERY source are
    combined, so the result stays consistent."""
    if not srcs:
        raise ValueError("no source dirs")
    tables = [t for t in UTT_TABLES
              if all(os.path.isfile(os.path.join(s, t)) for s in srcs)]
    if not tables:
        raise FileNotFoundError(f"no common tables across {srcs}")
    os.makedirs(dest, exist_ok=True)
    for t in tables:
        rows: List[List[str]] = []
        for s in srcs:
            rows.extend(read_table(os.path.join(s, t)))
        seen, dup = set(), set()
        for r in rows:
            (dup if r[0] in seen else seen).add(r[0])
        if dup:
            raise ValueError(f"duplicate utt ids in {t}: "
                             f"{sorted(dup)[:5]}...")
        write_table(os.path.join(dest, t), sorted(rows))
    _regen_spk2utt(dest)
    return len(read_table(os.path.join(dest, tables[0])))


def copy_data_dir(src: str, dest: str, utt_prefix: str = "",
                  spk_prefix: str = "") -> int:
    """Copy a data dir, optionally prefixing utt/spk ids
    (tools/copy_data_dir.sh --utt-prefix/--spk-prefix)."""
    os.makedirs(dest, exist_ok=True)
    n = 0
    for t in _utt_tables(src):
        rows = read_table(os.path.join(src, t))
        for r in rows:
            r[0] = utt_prefix + r[0]
            if t == "utt2spk":
                r[1] = spk_prefix + r[1]
        write_table(os.path.join(dest, t), sorted(rows))
        n = max(n, len(rows))
    if not _utt_tables(dest):
        raise FileNotFoundError(f"no data-dir tables in {src}")
    _regen_spk2utt(dest)
    # carry over non-table artifacts the recipes keep beside the tables
    for extra in ("trials",):
        p = os.path.join(src, extra)
        if os.path.isfile(p):
            shutil.copy(p, os.path.join(dest, extra))
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("spk2utt", help="utt2spk -> spk2utt (stdout)")
    s.add_argument("utt2spk")
    s = sub.add_parser("utt2spk", help="spk2utt -> utt2spk (stdout)")
    s.add_argument("spk2utt")

    f = sub.add_parser("filter", help="filter_scp.pl")
    f.add_argument("id_list")
    f.add_argument("table")
    f.add_argument("-f", "--field", type=int, default=1)
    f.add_argument("--exclude", action="store_true")

    x = sub.add_parser("fix", help="fix_data_dir.sh")
    x.add_argument("dir")

    u = sub.add_parser("subset", help="subset_data_dir.sh")
    u.add_argument("src")
    u.add_argument("dest")
    g = u.add_mutually_exclusive_group(required=True)
    g.add_argument("--utt-list")
    g.add_argument("--spk-list")
    g.add_argument("--first", type=int)
    g.add_argument("--last", type=int)

    c = sub.add_parser("combine", help="combine_data.sh")
    c.add_argument("dest")
    c.add_argument("srcs", nargs="+")

    cp = sub.add_parser("copy", help="copy_data_dir.sh")
    cp.add_argument("src")
    cp.add_argument("dest")
    cp.add_argument("--utt-prefix", default="")
    cp.add_argument("--spk-prefix", default="")

    args = p.parse_args(argv)
    if args.cmd == "spk2utt":
        for row in utt2spk_to_spk2utt(read_table(args.utt2spk)):
            print(" ".join(row))
    elif args.cmd == "utt2spk":
        for row in spk2utt_to_utt2spk(read_table(args.spk2utt)):
            print(" ".join(row))
    elif args.cmd == "filter":
        ids = [r[0] for r in read_table(args.id_list)]
        for row in filter_rows(ids, read_table(args.table),
                               field=args.field, exclude=args.exclude):
            print(" ".join(row))
    elif args.cmd == "fix":
        n = fix_data_dir(args.dir)
        print(f"fixed {args.dir}: {n} utts", file=sys.stderr)
    elif args.cmd == "subset":
        n = subset_data_dir(args.src, args.dest, utt_list=args.utt_list,
                            spk_list=args.spk_list, first=args.first,
                            last=args.last)
        print(f"subset {args.dest}: {n} utts", file=sys.stderr)
    elif args.cmd == "combine":
        n = combine_data_dirs(args.dest, args.srcs)
        print(f"combined {args.dest}: {n} utts", file=sys.stderr)
    elif args.cmd == "copy":
        n = copy_data_dir(args.src, args.dest, utt_prefix=args.utt_prefix,
                          spk_prefix=args.spk_prefix)
        print(f"copied {args.dest}: {n} utts", file=sys.stderr)


if __name__ == "__main__":
    main()
