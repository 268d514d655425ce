"""The runner the ``ab_*.py`` scripts share: run one timing program in two
source trees on one card, in turns A B, B A. Each run is a process of its
own, started in its tree, so each tree builds and runs its own kernels;
host noise that drifts through the call falls on both trees alike.

A script calls :func:`main` with its program, or :func:`trees`,
:func:`card`, :func:`turns` and :func:`run` where it reads its runs
another way. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

#: the pairs of runs a call makes: A B B A
PAIRS = 2


def trees(doc: str, flags=()) -> tuple:
    """Parse ``TREE_A [TREE_B]`` (B: this checkout) and the boolean
    options ``flags`` (names without the dashes); returns (A, B, options)
    with both trees absolute."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b", nargs="?",
                    default=os.path.dirname(os.path.abspath(__file__)))
    for flag in flags:
        ap.add_argument(f"--{flag}", action="store_true")
    opts = ap.parse_args()
    return os.path.abspath(opts.tree_a), os.path.abspath(opts.tree_b), opts


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them;
    printed."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return smi


def turns(a: str, b: str):
    """The trees in the order they run: A B, B A, ... (:data:`PAIRS`
    pairs)."""
    for i in range(PAIRS):
        yield from ((b, a) if i % 2 else (a, b))


def run(tree: str, child: str, args=(), prefix: str = "AB ",
        echo: str = "") -> str:
    """Run the Python source ``child`` with ``args`` in ``tree``; print and
    return its first line of output that starts with ``prefix``, and print
    the lines that start with ``echo`` (none if empty). Fails if the run
    exits non-zero or prints no such line."""
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run([sys.executable, "-c", child, *map(str, args)],
                         cwd=tree, env=env, capture_output=True, text=True,
                         timeout=900)
    lines = out.stdout.splitlines()
    for x in lines:
        if echo and x.lstrip().startswith(echo):
            print(f"[{tree}] {x}", flush=True)
    line = next((x for x in lines if x.startswith(prefix)), "")
    print(f"[{tree}] {line}", flush=True)
    if out.returncode or not line:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"{tree}: the timing run failed "
                         f"(rc {out.returncode})")
    return line


def main(doc: str, child: str, flags=(), echo: str = "") -> int:
    """The A/B of a program that prints one ``AB {json}`` line: the
    options ``flags`` go to it as 0 / 1 arguments, in order. Prints each
    run's line, then one JSON object: the card, every run, and each
    ``*_ms`` key's median per tree."""
    a, b, opts = trees(doc, flags)
    smi = card()
    args = [int(getattr(opts, f)) for f in flags]
    runs = [{"tree": t, **json.loads(run(t, child, args, echo=echo)[3:])}
            for t in turns(a, b)]
    keys = [k for k in runs[0] if k.endswith("_ms")]
    median = {t: {k: float(np.median([r[k] for r in runs if r["tree"] == t]))
                  for k in keys} for t in (a, b)}
    print(json.dumps({"card": smi, "runs": runs, "median": median}),
          flush=True)
    return 0
