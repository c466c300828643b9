"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources in ``csrc/`` compile, one nvcc per source and all at once, into
one shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), named by a hash of the sources and flags, under
``build/slam_torch_kernels/`` at the root of the checkout. The first call
in a process builds it when it is missing;
later calls reuse it. Pointers and the stream are passed as
``ctypes.c_void_p`` and ints as ``ctypes.c_int``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

from slam_decomposition_torch.config import build_dir

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_P, _I = ctypes.c_void_p, ctypes.c_int
# launcher name -> argtypes (the trailing c_void_p is the CUDA stream; the
# LM's and the polish's one before it their counter of J builds, may be null)
# (the *_generic entries run the depth-generic program at any k in 1..79;
# the others hand k >= 13 to it and run their instance at k <= 12)
SIGNATURES = {
    "slam_adam_chain": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],  # xout, fout (may be null)
    "slam_lm_chain": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "slam_polish_chain": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "slam_adam_chain_generic": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "slam_lm_chain_generic": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "slam_polish_chain_generic": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
}
MAX_THREADS_PER_SM = 2048  # sm_90
# kernel -> its occupancy query (k, *resident blocks per SM, *threads per block,
# *shared memory bytes a block, *whether that is dynamic shared memory) for
# the depth-k instance, and that of the depth-generic program (the same, with
# *lanes a block last: its shared memory is always dynamic)
OCCUPANCY = {
    "adam_chain": "slam_adam_chain_occupancy",
    "lm_chain": "slam_lm_chain_occupancy",
    "polish_chain": "slam_polish_chain_occupancy",
}
OCCUPANCY_GENERIC = {name: f"slam_{name}_generic_occupancy" for name in OCCUPANCY}
TEAM = {"adam_chain": 4, "lm_chain": 32, "polish_chain": 32}  # threads a lane


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> pathlib.Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir() / f"libslam_chain_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels if the library for these sources is missing.

    Returns {"path", "seconds" (0.0 when reused), "ptxas" (nvcc's -Xptxas -v
    report)}."""
    out = library_path()
    log = out.with_suffix(".ptxas.txt")
    if out.exists() and log.exists():
        return {"path": out, "seconds": 0.0, "ptxas": log.read_text()}
    out.parent.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{f.stem}.o") for f in cu]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(f)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f, o in zip(cu, objs)
    ]
    report = "".join(p.communicate()[0] for p in procs)
    ok = all(p.returncode == 0 for p in procs)
    if ok:  # link only what compiled
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False)
        report += link.stdout
        ok = link.returncode == 0
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    if not ok:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{report}")
    os.replace(tmp, out)
    log.write_text(report)
    return {"path": out, "seconds": seconds, "ptxas": report}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes declared."""
    lib = ctypes.CDLL(str(build()["path"]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name in (*OCCUPANCY.values(), *OCCUPANCY_GENERIC.values()):
        fn = getattr(lib, name)
        fn.argtypes = [_I, *[ctypes.POINTER(_I)] * 4]
        fn.restype = ctypes.c_int
    lib.slam_smem_per_sm.argtypes = [ctypes.POINTER(_I)] * 2
    lib.slam_smem_per_sm.restype = ctypes.c_int
    lib.slam_error_string.argtypes = [ctypes.c_int]
    lib.slam_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return load().slam_error_string(err).decode()


def occupancy(kernel: str, k: int, generic: bool = False) -> dict:
    """{"blocks", "threads", "warps", "smem", "dynamic", "room", "lanes"}:
    resident blocks per SM of the kernel's k-instance (with ``generic``, of
    its depth-generic program at depth k) on the current device (the CUDA
    occupancy calculator), its threads per block, the resident warps per SM,
    its shared memory a block in bytes, whether that is dynamic shared
    memory (a block's workspace past the 48 KB a kernel may declare; always
    for the generic program), the blocks an SM has room for by shared
    memory and threads alone (so ``blocks < room`` means the registers cost
    resident blocks), and its lanes a block."""
    lib = load()
    blocks, threads, smem, flag = _I(0), _I(0), _I(0), _I(0)
    query = (OCCUPANCY_GENERIC if generic else OCCUPANCY)[kernel]
    err = getattr(lib, query)(k, *map(ctypes.byref, (blocks, threads, smem, flag)))
    if err != 0:
        raise RuntimeError(f"{query}(k={k}) failed: {error_string(err)} ({err})")
    per_sm, reserved = _I(0), _I(0)
    err = lib.slam_smem_per_sm(ctypes.byref(per_sm), ctypes.byref(reserved))
    if err != 0:
        raise RuntimeError(f"slam_smem_per_sm failed: {error_string(err)} ({err})")
    room = min(per_sm.value // (smem.value + reserved.value), MAX_THREADS_PER_SM // threads.value)
    return {"blocks": blocks.value, "threads": threads.value, "warps": blocks.value * threads.value // 32,
            "smem": smem.value, "dynamic": generic or bool(flag.value), "room": room,
            "lanes": flag.value if generic else threads.value // TEAM[kernel]}


def sass_instructions() -> dict:
    """{kernel entry: SASS instructions} of the built library, counted from
    ``cuobjdump -sass`` (the code size each instance runs from)."""
    cuobjdump = pathlib.Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(build()["path"])], capture_output=True, text=True,
                          check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = 0
        elif fn is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[fn] += 1
    return out


def ptxas_summary(report: str) -> dict:
    """{kernel entry: {"registers", "spill_stores", "spill_loads",
    "stack_frame"}} from nvcc's -Xptxas -v report."""
    out = {}
    entry = props = None  # current entry function; function the next frame line describes
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props in out:
            out[props].update(
                stack_frame=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3))
            )
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
    return out
