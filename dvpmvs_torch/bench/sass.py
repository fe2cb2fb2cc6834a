"""Instruction counts by pipe from the SASS of a built library.

``cuobjdump -sass`` disassembles the cubins inside a library that
``kernels/_build.py`` built; ``loop_counts`` takes one kernel's innermost
loop with the most instructions (a kernel's hot loop) and counts its
instructions by the pipe that executes them.  ``PIPE_LANES`` gives each
pipe's lanes a clock on one SM of compute capability 9.0 (the CUDA C++
Programming Guide's throughput table: 128 fp32 add / multiply / fma, 64
integer add, logic, shift, compare, select and multiply-add, 16
conversions), and ``issue``, the dispatch of one warp instruction a clock
by each of the SM's four schedulers, which every instruction takes.
"""

from __future__ import annotations

import importlib.util
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

PIPE_LANES = {"alu": 64, "fp32": 128, "imad": 64, "fma": 128, "conv": 16,
              "issue": 128}
# Hopper's VIMNMX and VIADDMNMX (integer min / max, add then min / max) are
# counted on the integer pipe, its VIADD (integer add) on the FMA pipe's
# heavy half with IMAD: the Programming Guide's table does not list them,
# and prim_vshift runs faster than its count allows with VIADD on the
# integer pipe
_ALU = {"IADD3", "IADD", "IADD32I", "VIADDMNMX", "LOP3", "LOP",
        "LOP32I", "SHF", "SHL", "SHR", "IMNMX", "VIMNMX", "VIMNMX3", "ISETP",
        "ICMP", "SEL", "PRMT",
        "LEA", "MOV", "MOV32I", "IABS", "FLO", "POPC", "BMSK", "SGXT",
        "PLOP3", "P2R", "R2P", "FSEL", "FSETP", "FMNMX", "BREV", "ISCADD",
        "VABSDIFF", "VABSDIFF4", "CSET", "CSETP"}
_FP32 = {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD",
         "HFMA2"}
_IMAD = {"IMAD", "IMAD32I", "IMUL", "IMUL32I", "IDP", "IMADSP", "VIADD"}
_CONV = {"I2F", "F2I", "F2F", "I2I", "I2FP", "F2IP", "FRND", "MUFU"}
_SHARED = {"LDS", "STS", "LDSM", "ATOMS"}

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"BRA\S*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def cuobjdump() -> str:
    """The toolkit's cuobjdump, or the one Triton's package carries."""
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "cuobjdump").exists():
            return str(Path(cand) / "bin" / "cuobjdump")
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/cuobjdump")
    if default.exists():
        return str(default)
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cand = (Path(spec.origin).parent / "backends" / "nvidia" / "bin" /
                "cuobjdump")
        if cand.exists():
            return str(cand)
    raise RuntimeError("cuobjdump not found: set CUDA_HOME or put it on PATH")


def disassemble(library: Path) -> str:
    return subprocess.run([cuobjdump(), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def functions(sass: str) -> Dict[str, List[tuple]]:
    """name -> [(address, instruction text, label or None)] per function;
    the label is the one that names the instruction's address."""
    out: Dict[str, List[tuple]] = {}
    cur = None
    label = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            label = None
            continue
        m = _LABEL.match(line)
        if m:
            label = m.group(1)
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), label))
            label = None
    return out


def opcode(text: str) -> str:
    """The mnemonic without predicate and modifiers: '@!P0 IMAD.MOV.U32
    R1, ...' -> 'IMAD'."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def pipe_of(op: str) -> str:
    if op in _ALU:
        return "alu"
    if op in _FP32:
        return "fp32"
    if op in _IMAD:
        return "imad"
    if op in _CONV:
        return "conv"
    if op in _SHARED:
        return "shared"
    if op.startswith("U") or op in ("S2UR", "R2UR", "VOTEU"):
        return "uniform"
    return "other"


def innermost_loop(insns: List[tuple]) -> List[tuple]:
    """The instructions of the innermost loop (a backward branch's range
    that holds no other backward branch) with the most instructions."""
    at = {label: addr for addr, _, label in insns if label}
    loops = []
    for addr, text, _ in insns:
        m = _TARGET.search(text)
        if not m:
            continue
        target = at.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target <= addr:
            loops.append((target, addr))
    inner = [lo for lo in loops if not any(
        o != lo and lo[0] <= o[0] and o[1] <= lo[1] for o in loops)]
    if not inner:
        return []
    lo, hi = max(inner, key=lambda r: sum(
        1 for a, _, _ in insns if r[0] <= a <= r[1]))
    return [i for i in insns if lo <= i[0] <= hi]


def loop_counts(insns: List[tuple]) -> Dict[str, object]:
    """Instructions of the hot loop by pipe ('issue': all of them), the
    opcodes' counts, and the conversions (I2F and kin) of the whole
    function."""
    body = innermost_loop(insns)
    ops = [opcode(t) for _, t, _ in body]
    pipes: Dict[str, int] = {}
    for op in ops:
        pipes[pipe_of(op)] = pipes.get(pipe_of(op), 0) + 1
    pipes["issue"] = len(ops)
    pipes["fma"] = pipes.get("fp32", 0) + pipes.get("imad", 0)
    hist: Dict[str, int] = {}
    for op in ops:
        hist[op] = hist.get(op, 0) + 1
    return {"pipes": pipes, "opcodes": hist,
            "conversions": sorted({opcode(t) for _, t, _ in insns} & _CONV)}
