#!/usr/bin/env python3
"""Registers, stack and spills of every hand-written CUDA kernel.

Run from the root of a checkout on a machine with the CUDA toolkit:

    python3 tools/kernel_resources.py

It compiles each ``src/repro_torch/kernels/csrc/*.cu`` with the port's
flags plus ``-Xptxas -v`` and prints one line per kernel entry (ptxas's
registers, stack frame and spill bytes). It exits non-zero if a source
fails to compile.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    from repro_torch.kernels import _lib
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for src in _lib.sources():
            cmd = _lib.compile_command(src, Path(tmp) / (src.stem + ".o"),
                                       "-Xptxas", "-v")
            res = subprocess.run(cmd, capture_output=True, text=True)
            ok &= res.returncode == 0
            entry = None
            for line in (res.stdout + res.stderr).splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    entry = m.group(1)
                    frame = line
                    continue
                if "spill" in line:
                    frame = line.strip()
                m = re.search(r"Used (\d+) registers", line)
                if m and entry:
                    print(f"{src.name:26s} {m.group(1):>3s} registers  "
                          f"{frame}  {entry}")
                    entry = None
            if res.returncode:
                print(res.stdout + res.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
