#!/usr/bin/env python3
"""What the compiler made of the port's CUDA kernels: instructions per loop.

    python3 tools/torch_kernel_sass.py [--root DIR] [--out DIR] resample ...

Builds the kernel libraries of the ``moonrtx_tpu_torch`` package under
``--root`` (default: this checkout; a second checkout of another commit
compares two designs), disassembles each named library with
``cuobjdump -sass`` and prints, per ``__global__`` function, its
instruction count and every loop (a branch back to an earlier address)
with the instructions of its body by class: global and shared loads and
stores, integer, float, conversions, control. An instruction-bound loop
shows as a body of many instructions per element it handles. The whole
listing goes to ``--out`` (default chip_smoke_out/sass). Needs nvcc and
cuobjdump (a machine with the CUDA toolkit); no card.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

CLASSES = (
    ("global load", ("LDG", "LD.", "LDC", "ULDC")),
    ("global store", ("STG", "ST.")),
    ("shared load", ("LDS",)),
    ("shared store", ("STS",)),
    ("convert", ("I2F", "F2I", "F2F", "I2I", "F2FP", "PRMT")),
    ("float", ("FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "MUFU",
               "FCHK", "FRND")),
    ("control", ("BRA", "BSSY", "BSYNC", "EXIT", "BAR", "WARPSYNC", "SHFL",
                 "CALL", "RET", "NOP", "DEPBAR")),
)


def classify(op: str) -> str:
    for name, prefixes in CLASSES:
        if any(op.startswith(p) for p in prefixes):
            return name
    return "integer and other"


def functions(sass: str):
    """{function name: [(address, opcode, text), ...]} of a listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and cur is not None:
            text = m.group(2).strip()
            op = text.split()[1] if text.startswith("@") else text.split()[0]
            cur.append((int(m.group(1), 16), op, text))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--root", default=here,
                    help="checkout whose moonrtx_tpu_torch is built")
    ap.add_argument("--out", default=os.path.join(here, "chip_smoke_out",
                                                  "sass"))
    ap.add_argument("libraries", nargs="+", help="e.g. resample")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    from moonrtx_tpu_torch import kernels

    kernels.build_all()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    os.makedirs(args.out, exist_ok=True)
    tag = os.path.basename(os.path.abspath(args.root))
    for name in args.libraries:
        lib = kernels.BUILD_ROOT / kernels._key() / f"lib{name}.so"
        sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout
        with open(os.path.join(args.out, f"{tag}_{name}.sass"), "w") as f:
            f.write(sass)
        regs = [ln.strip() for ln in kernels.build_log.get(name, "")
                .splitlines() if "registers" in ln]
        print(f"# {tag}/{name}: {' | '.join(regs)}")
        for fn, ins in functions(sass).items():
            print(f"{tag}/{name} {fn}: {len(ins)} instructions")
            index = {addr: i for i, (addr, _, _) in enumerate(ins)}
            for i, (addr, op, text) in enumerate(ins):
                m = re.search(r"BRA\S*\s+(?:\S+,\s*)?0x([0-9a-f]+)", text)
                if not m or int(m.group(1), 16) > addr:
                    continue
                start = index.get(int(m.group(1), 16))
                if start is None:
                    continue
                body = ins[start:i + 1]
                mix = collections.Counter(classify(o) for _, o, _ in body)
                print(f"  loop {ins[start][0]:#06x}-{addr:#06x}: "
                      f"{len(body)} instructions: "
                      + ", ".join(f"{k} {v}" for k, v in mix.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
