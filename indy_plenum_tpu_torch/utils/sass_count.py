"""Count the SASS instructions of the port's CUDA kernels.

    python -m indy_plenum_tpu_torch.utils.sass_count [--ptxas] [sha256.cu ...]

Compiles each named source under ``csrc/`` (all of them by default) to a
cubin with the library's own ``nvcc`` flags, disassembles it with
``cuobjdump -sass`` and prints one JSON line per kernel: its instruction
count, the count of integer ALU instructions (everything but moves,
loads, stores, branches, NOPs and the uniform datapath), and a histogram
by opcode. It is how ``chip_smoke.py``'s hand-counted instructions per
unit of work are checked against what the compiler emits. With
``--ptxas``, one JSON line per source instead: what ``nvcc -Xptxas -v``
reports for each kernel (registers, stack, spill stores and loads).
Needs the CUDA toolkit (``nvcc`` and ``cuobjdump``); no card.
"""
from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import tempfile

from .kernel_build import CSRC_DIR, NVCC_FLAGS, find_nvcc

# opcodes that move, load, store or branch: not arithmetic on the data
_NOT_ALU = {"MOV", "LDG", "STG", "LDC", "LDS", "STS", "LD", "ST", "LDL",
            "STL", "BRA", "EXIT", "NOP", "S2R", "S2UR", "CS2R", "BAR",
            "BSSY", "BSYNC", "WARPSYNC", "RET", "CALL", "DEPBAR"}
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def disassemble(source: str) -> str:
    nvcc = find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as work:
        cubin = os.path.join(work, "k.cubin")
        flags = [f for f in NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
        subprocess.run([nvcc, *flags, "-I", CSRC_DIR, "-cubin", source,
                        "-o", cubin], check=True, capture_output=True)
        return subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout


def ptxas_report(source: str, nvcc: str = None) -> list:
    """The ``-Xptxas -v`` lines of one source's compile (entry names,
    stack and spills, registers)."""
    proc = subprocess.run(
        [nvcc or find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", source,
         "-o", os.devnull, "-I", CSRC_DIR],
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}: {proc.stderr[-2000:]}")
    keep = ("Compiling entry", "spill", "Used")
    return [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if any(k in line for k in keep)]


def count(sass: str):
    """{kernel: Counter of base opcodes}, kernels by mangled name."""
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            out[current] = collections.Counter()
            continue
        m = _INSN.search(line)
        if current is not None and m:
            op = m.group(1)
            # ptxas writes many register moves as IMAD.MOV on the FMA pipe
            out[current]["MOV" if op.startswith("IMAD.MOV")
                         else op.split(".")[0]] += 1
    return out


def int_alu(hist) -> int:
    """Integer ALU instructions of one kernel's opcode histogram."""
    return sum(c for op, c in hist.items()
               if op not in _NOT_ALU and not op.startswith("U"))


def main(argv) -> int:
    ptxas = "--ptxas" in argv
    argv = [a for a in argv if a != "--ptxas"]
    names = argv or sorted(n for n in os.listdir(CSRC_DIR)
                           if n.endswith(".cu"))
    for name in names:
        if ptxas:
            print(json.dumps({"source": name, "ptxas": ptxas_report(
                os.path.join(CSRC_DIR, name))}))
            continue
        for kernel, hist in count(disassemble(
                os.path.join(CSRC_DIR, name))).items():
            print(json.dumps({"source": name, "kernel": kernel,
                              "instructions": sum(hist.values()),
                              "int_alu": int_alu(hist),
                              "histogram": dict(hist.most_common())}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
