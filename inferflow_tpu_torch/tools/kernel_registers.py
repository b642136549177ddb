"""The registers and stack of every kernel of the port's CUDA sources, as
the built libraries state them (``cuobjdump -res-usage``).

    python -m inferflow_tpu_torch.tools.kernel_registers \\
        [--sources unpack_exp,decode_step] [--out FILE]

Builds the sources if they are not built yet (``kernels/_build.build``),
then prints one JSON object {source: {kernel's mangled name: {"REG": n,
"STACK": bytes, "LOCAL": bytes}}} (and writes it to FILE).  A change to a
shared header (``csrc/gemv_mma.cuh``) can move ptxas's registers for every
kernel that includes it: run this from two trees (the parent unpacked
under ``build/`` with ``git archive``, this file copied into it) on the
card machine and compare.  Needs nvcc and cuobjdump (the CUDA toolkit),
not a card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys

from ..kernels import _build


def usage(name: str) -> dict:
    """{kernel: {"REG", "STACK", "LOCAL"}} of csrc/<name>.cu's library."""
    _build.build((name,))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run(
        [cuobjdump, "-res-usage", str(_build.library_path(name))],
        check=True, stdout=subprocess.PIPE, text=True).stdout
    kernels, current = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function (\S+):", line)
        if head:
            current = head.group(1)
            continue
        if current is not None and "REG:" in line:
            fields = dict(re.findall(r"(\w+):(\d+)", line))
            kernels[current] = {key: int(fields[key])
                                for key in ("REG", "STACK", "LOCAL")}
            current = None
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sources", default=",".join(_build.SOURCES),
                    help="comma list of csrc/<name>.cu")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    names = [s for s in args.sources.split(",") if s]
    _build.start(names)
    result = {name: usage(name) for name in names}
    text = json.dumps(result, sort_keys=True)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
