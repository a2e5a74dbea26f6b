"""Dump the eager op log of one request (or training step) of the port and
map op, kernel or mechanism names to their first line: the counterpart of
``tools/dump_hlo.py``.

    python tools/dump_ops_torch.py [--out output/ops/mssvt.ops]
        [--map NAME,...] [--train] [--tiny] [--device cuda|cpu] [--batch 4]

The port runs eagerly and has no compiled module, so the log of the ops
that one counted request ran (``tools/op_bytes_torch.py``'s run, with
``counting(log=True)``) takes the place of the optimized HLO. One line a
charge, tab-separated: its sequence number, the aten op
(``aten.mm.default``) or ``kernel:<name>``, its operands and its results
as dtype and shape (``bf16[96000,48,128]``; ``@cpu`` off the device), the
bytes charged and the mechanism key. The bytes summed are the tally's
``total_bytes()``; ``op_bytes_torch.py --log FILE`` reads the file back.

``--map`` prints the first line of each named op (``aten.index.Tensor``,
``aten.index`` or ``aten::index``, the spelling of
``tools/profile_top_ops_torch.py --host``), kernel (``attention``) or key
(any part of one, ``gather_window_voxels``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import op_bytes_torch  # noqa: E402

DEFAULT_OUT = "output/ops/mssvt.ops"


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--map", default="", metavar="NAME,...")
    ap.add_argument("--train", action="store_true",
                    help="log a training step, not a request")
    ap.add_argument("--tiny", action="store_true",
                    help="mssvt_tiny.yaml (CPU rehearsals)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    return ap.parse_args(argv)


def write_log(tally, path, what):
    """Writes ``tally.ops`` to ``path``; returns the lines' bytes."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    total = 0
    with open(path, "w") as f:
        f.write(f"# per {what}\n# seq\top\toperands\tresults\tbytes\tkey\n")
        for seq, name, operands, results, nbytes, key in tally.ops:
            f.write(f"{seq}\t{name}\t{operands}\t{results}\t{nbytes}\t{key}\n")
            total += nbytes
    return total


def matches(fields, name):
    op, key = fields[1], fields[5]
    name = name.replace("::", ".")
    return op == name or op.rsplit(".", 1)[0] == name or \
        op == f"kernel:{name}" or name in key


def map_names(path, names):
    """The first line of ``path`` that each name matches."""
    found = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            for name in names:
                if name not in found and matches(fields, name):
                    found[name] = line.rstrip("\n")
            if len(found) == len(names):
                break
    return found


def main(argv=None, built=None):
    """``built``: a caller's ``op_bytes_torch.build(...)`` to reuse."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if built is None:
        built = op_bytes_torch.build(args.tiny, args.device, args.batch,
                                     args.train)
    tally = op_bytes_torch.count(built, args.train, log=True)
    total = write_log(tally, args.out, "step" if args.train else "request")
    print(f"# wrote {len(tally.ops)} ops, {total / 1e9:.3f} GB, to "
          f"{args.out}", file=sys.stderr)
    names = [n for n in args.map.split(",") if n]
    found = map_names(args.out, names)
    for name in names:
        print(f"\n=== {name}: {found.get(name, 'not in the log')[:400]}")
    return tally


if __name__ == "__main__":
    main()
    sys.exit(0)
