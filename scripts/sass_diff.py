#!/usr/bin/env python3
"""The SASS of every kernel in this checkout's library against another
checkout's, on a machine with nvcc and cuobjdump.

    python3 scripts/sass_diff.py OTHER_CHECKOUT [PATTERN]

builds both kernel libraries (kernels/build.py, each in its own process)
and prints, kernel by kernel, whether its SASS is identical (instruction
addresses dropped, blanks collapsed), differs, or lies in one library only; with PATTERN,
also the first lines of a unified diff of the first differing kernel
whose name holds PATTERN.  Kernels are
matched by their source file and their demangled names (cu++filt) without
the parameter list, a split-line kernel's storage type dropped where it
equals the compute type after it (`split_staged_kernel<float, float, ...>`
matches a checkout's `split_staged_kernel<float, ...>` from before the
storage type).  A kernel whose SASS is identical runs the same
instructions: no A/B can tell the two apart.
"""
import difflib
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
CUFILT = ("/usr/local/cuda/bin/cu++filt"
          if os.path.exists("/usr/local/cuda/bin/cu++filt") else "c++filt")
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from adi_thermal_fields_tpu_torch.kernels import build_library; "
         "print(build_library()[0])")


def library(root):
    proc = subprocess.run([sys.executable, "-c", BUILD, root],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{root}: build failed\n{proc.stderr}")
    return proc.stdout.strip().splitlines()[-1]


def key(mangled, demangled):
    """file: demangled name, no parameters, S = C dropped."""
    m = re.search(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+", mangled)
    name = demangled.split("(anonymous namespace)::")
    name = "".join(name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):            # the parameter list's "("
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    name = re.sub(r"(split_(?:staged|strided)_kernel<)([\w ]+), \2, ",
                  r"\1\2, ", name[:cut])
    return f"{m.group(1) if m else '?'}: {name}"


def sass(lib):
    """{kernel: its SASS without addresses}."""
    text = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    mangled = re.findall(r"\s*Function : (\S+)", text)
    demangled = subprocess.run([CUFILT], input="\n".join(mangled),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    names = {m: key(m, d) for m, d in zip(mangled, demangled)}
    funcs, name, body = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                funcs[name] = "\n".join(body)
            name = names[m.group(1)]
            body = []
        elif name:
            # addresses dropped, runs of blanks made one: the listing's
            # column widths are layout, not code
            body.append(" ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "",
                                        line).split()))
    if name:
        funcs[name] = "\n".join(body)
    return funcs


def main():
    other = sass(library(os.path.abspath(sys.argv[1])))
    mine = sass(library(HERE))
    for name in sorted(set(other) | set(mine)):
        state = ("only in the other" if name not in mine
                 else "only in this" if name not in other
                 else "identical" if mine[name] == other[name]
                 else "differs")
        print(f"{state:17s} {name}", flush=True)
    pattern = sys.argv[2] if len(sys.argv) > 2 else None
    for name in sorted(mine):
        if pattern and pattern in name and other.get(name, mine[name]) \
                != mine[name]:
            diff = difflib.unified_diff(other[name].splitlines(),
                                        mine[name].splitlines(), "other",
                                        "this", lineterm="", n=1)
            print("\n".join(list(diff)[:80]), flush=True)
            break
    same = sum(1 for n in mine if other.get(n) == mine[n])
    print(f"{same} identical of {len(mine)} kernels here, {len(other)} "
          "there", flush=True)


if __name__ == "__main__":
    main()
