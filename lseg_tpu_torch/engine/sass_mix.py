"""Count the SASS instructions of built kernels by opcode: what a kernel
compiles to, read from the kernel library (`cuobjdump --dump-sass`).

    python -m lseg_tpu_torch.engine.sass_mix NAME [NAME ...] [--top N]

Builds the kernels if needed (`ops._build.load_kernels`), and prints one
JSON line: for every compiled copy of each kernel whose name (as
`ops._build._kernel_name` gives it) starts with a NAME, its instruction
count and its N most frequent opcodes (the mnemonic before its first dot,
predicates left out), summed over the whole function (a static count, not
an executed one). Without nvcc it exits 1.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path


def opcode_mix(sass: str, names, top: int) -> dict:
    """{kernel (copy index appended): {"instructions": n, "top": {op: n}}}
    of the functions of a `cuobjdump --dump-sass` listing."""
    from lseg_tpu_torch.ops._build import _kernel_name

    out = {}
    for sec in sass.split("Function : ")[1:]:
        name = _kernel_name(sec.split(None, 1)[0])
        if not name.startswith(tuple(names)):
            continue
        ops = collections.Counter()
        for line in sec.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                         line)
            if m:
                ops[m.group(2)] += 1
        key = name
        i = 1
        while key in out:
            i += 1
            key = f"{name}#{i}"
        out[key] = {"instructions": sum(ops.values()),
                    "top": dict(ops.most_common(top))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="+")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    from lseg_tpu_torch.ops._build import find_nvcc, library_path, load_kernels

    try:
        load_kernels()
        tool = Path(find_nvcc()).with_name("cuobjdump")
    except RuntimeError as e:
        print(f"sass_mix: {e}", file=sys.stderr)
        return 1
    proc = subprocess.run([str(tool), "--dump-sass", str(library_path())],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(f"sass_mix: {proc.stderr.strip()[:500]}", file=sys.stderr)
        return 1
    print(json.dumps(opcode_mix(proc.stdout, args.names, args.top)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
