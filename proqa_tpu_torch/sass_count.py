"""Instruction counts of a built kernel's main loop, from its SASS: the
ground for an instruction-issue bound beside a kernel's bytes bound.

    python -m proqa_tpu_torch.sass_count [FRAGMENT ...]

`cuobjdump -sass` of the kernel library (`_build.library_path()`, built
first) lists each kernel's instructions with their addresses. A loop is a
backward branch: the instructions from its target to the branch. A kernel's
largest loop is its main loop; its instructions, over the elements one
thread takes in an iteration, are what a thread issues an element. A loop
that holds both sides of a branch is counted whole: a warp whose lanes take
both sides issues both. FRAGMENT picks kernels by a piece of their mangled
name (default: the backward epilogue kernels). Needs the CUDA toolkit's
cuobjdump (on PATH or under CUDA_HOME); prints one JSON object.

    python -m proqa_tpu_torch.sass_count --ptxas LOG [OTHER_LOG]

reads instead the ptxas report that `_build.build` keeps beside the library
(`<library>.log`): each kernel's registers, spill bytes, barriers and shared
memory, keyed by its mangled name; with a second log (another checkout's
build), only the kernels whose lines differ and those in one log alone.

    python -m proqa_tpu_torch.sass_count --sass LIBRARY OTHER_LIBRARY

compares two builds' kernels instruction by instruction: each kernel keyed
by its demangled name (template arguments included; the anonymous
namespace's build hashes vanish in demangling), its SASS with the
addresses dropped and its labels numbered in order; prints the count of
kernels whose SASS is the same, those that differ and those in one build
alone. Needs cu++filt beside cuobjdump.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

# F1's backward with GELU over bf16, summing (dense_epilogue_bwd_kernel<bf16,
# vector, GELU, sum>), and its sum alone; F2's backward over bf16 at width 768
# with the scale and bias gradients (add_layer_norm_bwd_kernel<bf16, 8, 3, true>)
KERNELS = {
    "F1 backward GELU": "dense_epilogue_bwd_kernelI13__nv_bfloat16Lb1ELb1ELb1E",
    "F1 backward sum": "dense_epilogue_bwd_kernelI13__nv_bfloat16Lb1ELb0ELb1E",
    "F2 backward": "add_layer_norm_bwd_kernelI13__nv_bfloat16Li8ELi3ELb1E",
}

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"/\*([0-9a-f]+)\*/\s+([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRANCH = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)\)?$")


def functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """Each function's (address, instruction) list; a label line is kept in
    its place as (-1, label)."""
    out: dict[str, list[tuple[int, str]]] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        if current is None:
            continue
        m = _LABEL.match(line)
        if m:
            current.append((-1, m.group(1)))
            continue
        m = _INSTRUCTION.search(line)
        if m:
            current.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def main_loop(instructions: list[tuple[int, str]]) -> dict:
    """The largest loop of one function: its instruction count and the
    counts of its global 16-byte loads and stores and its MUFU (special
    function unit) instructions. None if it has no loop."""
    labels, code = {}, []
    for addr, text in instructions:
        if addr < 0:
            labels[text] = None  # resolved by the next instruction
            continue
        for name, at in labels.items():
            if at is None:
                labels[name] = addr
        code.append((addr, text))
    best = None
    for addr, text in code:
        m = _BRANCH.search(text)
        if not m:
            continue
        target = m.group(1)
        start = int(target, 16) if target.startswith("0x") else labels.get(target)
        if start is None or start > addr:
            continue
        body = [t for a, t in code if start <= a <= addr]
        if best is None or len(body) > len(best):
            best = body
    if best is None:
        return None
    ops = [t.split()[1] if t.startswith("@") else t.split()[0] for t in best]
    return {"instructions": len(best),
            "global_loads_128": sum(o.startswith("LDG") and ".128" in o for o in ops),
            "global_stores_128": sum(o.startswith("STG") and ".128" in o for o in ops),
            "mufu": sum(o.startswith("MUFU") for o in ops)}


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "cuobjdump")


def loop_counts(library: str, fragments: dict[str, str]) -> dict[str, dict | None]:
    """main_loop of the first kernel in `library` whose mangled name holds
    each fragment (None where none does)."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    funcs = functions(sass)
    out = {}
    for key, fragment in fragments.items():
        names = [n for n in funcs if fragment in n]
        out[key] = main_loop(funcs[names[0]]) if names else None
    return out


def _demangle(names: list[str]) -> list[str]:
    tool = os.path.join(os.path.dirname(_cuobjdump()), "cu++filt")
    out = subprocess.run([tool], input="\n".join(names) + "\n", capture_output=True, text=True,
                         check=True).stdout.splitlines()
    assert len(out) == len(names)
    return out


def normalized(funcs: dict[str, list[tuple[int, str]]],
               names: list[str]) -> dict[str, list[str]]:
    """{names[i]: the instructions of the i-th function of `funcs`}, the
    addresses dropped and the labels renumbered in their order within the
    function."""
    out = {}
    for (_, instructions), name in zip(funcs.items(), names):
        labels: dict[str, str] = {}

        def label(m):
            return labels.setdefault(m.group(0), f".L{len(labels)}")
        out[name] = [re.sub(r"\.L_x_\d+", label, text) for _, text in instructions]
    return out


def kernel_sass(library: str) -> dict[str, list[str]]:
    """{demangled kernel name: its normalized instructions} of a library."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    funcs = functions(sass)
    return normalized(funcs, _demangle(list(funcs)))


def sass_diff(a: dict[str, list[str]], b: dict[str, list[str]]) -> dict:
    """The kernels of both builds whose SASS is the same (a count), those
    whose SASS differs, and those in one build alone."""
    both = a.keys() & b.keys()
    return {"same": sum(a[k] == b[k] for k in both),
            "differ": sorted(k for k in both if a[k] != b[k]),
            "first_only": sorted(a.keys() - b.keys()), "second_only": sorted(b.keys() - a.keys())}


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PROPERTIES = re.compile(r"Function properties for (\S+)")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(.*)")
# the anonymous namespace's name carries hashes that change with each build
_ANONYMOUS = re.compile(r"(_GLOBAL__N__)[0-9a-f]{8}(_\d+_\w+?_cu_)[0-9a-f]{8}")


def ptxas_report(log: str) -> dict[str, dict]:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads",
    "resources"}} from `nvcc -Xptxas -v` output (the rest of the "Used"
    line: barriers, shared and constant memory); the anonymous namespace's
    build hashes are taken out of the names, so two builds compare."""
    report, name = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line) or _PROPERTIES.search(line)
        if m:
            name = _ANONYMOUS.sub(r"\1\2", m.group(1))
            report.setdefault(name, {})
            continue
        if name is None:
            continue
        if m := _SPILLS.search(line):
            report[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif m := _USED.search(line):
            report[name].update(registers=int(m.group(1)), resources=m.group(2).strip(", "))
    return {k: v for k, v in report.items() if "registers" in v}


def ptxas_diff(a: dict[str, dict], b: dict[str, dict]) -> dict[str, list]:
    """The kernels whose reports differ, and those in one report alone."""
    return {"differ": sorted(k for k in a.keys() & b.keys() if a[k] != b[k]),
            "first_only": sorted(a.keys() - b.keys()), "second_only": sorted(b.keys() - a.keys())}


def main(argv=None) -> int:
    from proqa_tpu_torch import _build

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--sass"]:
        print(json.dumps(sass_diff(*(kernel_sass(lib) for lib in argv[1:3]))))
        return 0
    if argv[:1] == ["--ptxas"]:
        reports = [ptxas_report(open(path).read()) for path in argv[1:3]]
        print(json.dumps(reports[0] if len(reports) == 1 else ptxas_diff(*reports)))
        return 0
    fragments = {f: f for f in argv} or KERNELS
    print(json.dumps(loop_counts(str(_build.build()), fragments)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
