"""Lazy builder, loader and wrappers of the hand-written CUDA kernels.

The sources live in ``cocircom_tpu_torch/csrc`` (one ``.cu`` per kernel over
the shared headers ``field.cuh`` and ``curve.cuh``).  Every kernel is a
template over the limb count and is built for 8 limbs (BN254 Fr and Fq,
BLS12-381 Fr) and 12 limbs (BLS12-381 Fq); a wrapper takes the limb count
from its operands and the C entry point dispatches.  At first use every
source is compiled by its own ``nvcc`` process, all started together, into
``cocircom_tpu_torch/_build/<hash of the sources>/`` as a shared library
with a plain C interface, and loaded with ``ctypes``.  Importing this
module needs neither ``nvcc`` nor a card.

Each wrapper checks device, dtype, shape and contiguity and raises on what
the kernel does not take, allocates outputs with ``torch.empty``, launches
on ``torch.cuda.current_stream()``, raises if the C function returns a
non-zero ``cudaGetLastError()``, and adds one to its launch count (kept per
kernel and limb count: ``mont_mul`` for 8 limbs, ``mont_mul_l12`` for 12).
There is no fallback: a wrapper launches its kernel or raises.  The plain
PyTorch version of each kernel lives beside its caller (ops/field.py,
ops/ntt.py, ops/curve.py) and is taken there only for CPU tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

# every counted entry point; one .cu (and one shared library) each
KERNELS = ("mont_mul", "ntt_butterfly", "ntt_columns", "ec_add", "ec_madd", "ec_wave_add",
           "ec_add_g2", "ec_wave_add_g2")
LIMBS = (8, 12)  # 32-bit limbs per element the kernels are instantiated for
# The function of the JAX package (cocircom_tpu/ops/pallas_*.py) that each
# kernel takes the place of; the G2 add and the G2 wave replace XLA
# compositions.
REPLACES = {
    "mont_mul": "pallas_field.mont_mul_pallas",
    "ntt_butterfly": "pallas_field.butterfly_pallas",
    "ntt_columns": "pallas_ntt.fourstep_ntt",
    "ec_add": "pallas_curve.ec_add_pallas",
    "ec_madd": "pallas_curve.ec_madd_pallas",
    "ec_wave_add": "pallas_curve.ec_wave_add_pallas",
    "ec_add_g2": None,
    "ec_wave_add_g2": None,
}


def count_key(name: str, limbs: int) -> str:
    """The launch count's name: the kernel's own for 8 limbs, else with the
    limb count appended."""
    return name if limbs == 8 else f"{name}_l{limbs}"


COUNT_KEYS = tuple(count_key(k, n) for n in LIMBS for k in KERNELS)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
# -Xptxas -v: registers and spill bytes of every instantiation go to the
# build log kept beside each library (lib<kernel>.log)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
_counts = {k: 0 for k in COUNT_KEYS}
_count_lock = threading.Lock()


# ------------------------------------------------------------------ shapes

def broadcast_shapes(a, b) -> tuple:
    """Broadcast of two batch shapes (a light stand-in for
    torch.broadcast_shapes, which is slow for how often it runs here)."""
    a, b = tuple(a), tuple(b)
    if a == b:
        return a
    if len(a) < len(b):
        a = (1,) * (len(b) - len(a)) + a
    elif len(b) < len(a):
        b = (1,) * (len(a) - len(b)) + b
    out = []
    for x, y in zip(a, b):
        if x != y and x != 1 and y != 1:
            raise ValueError(f"shapes {a} and {b} do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


# ------------------------------------------------------------ launch counts

def _count(name: str) -> None:
    with _count_lock:
        _counts[name] += 1


def launch_counts() -> dict:
    with _count_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _count_lock:
        for k in _counts:
            _counts[k] = 0


# ------------------------------------------------------------------ build

def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _source_hash()


# seconds each source's nvcc took in the last build of this process
# ({} when everything was built already)
build_seconds: dict = {}


def build_all() -> Path:
    """Compile every kernel that is not built yet (one nvcc each, started
    together) and return the build directory.  Raises on any failure."""
    out = build_dir()
    with _lock:
        out.mkdir(parents=True, exist_ok=True)
        todo = [k for k in KERNELS if not (out / f"lib{k}.so").exists()]
        if not todo:
            return out
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for k in todo:
            tmp = out / f"lib{k}.so.tmp{os.getpid()}"
            log = open(out / f"lib{k}.log.tmp{os.getpid()}", "w")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{k}.cu")]
            procs[k] = (tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
        build_seconds.clear()
        while len(build_seconds) < len(procs):
            for k, (_, _, proc) in procs.items():
                if k not in build_seconds and proc.poll() is not None:
                    build_seconds[k] = round(time.perf_counter() - t0, 2)
            time.sleep(0.05)
        failed = []
        for k, (tmp, log, proc) in procs.items():
            log.close()
            log_path = Path(log.name)
            if proc.returncode != 0:
                failed.append(f"{k}: nvcc exit {proc.returncode}\n{log_path.read_text()}")
                continue
            os.replace(log_path, out / f"lib{k}.log")
            os.replace(tmp, out / f"lib{k}.so")
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


_ENTRY = re.compile(
    r"Compiling entry function '(_Z\d+([a-z0-9_]+?)_kernelILi(\d+)E(?:Li(\d+)E)?\w*)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")


def parse_ptxas(log: str) -> dict:
    """What `nvcc -Xptxas -v` printed, by kernel instantiation:
    {"<kernel>_l<limbs>[_s<team>]": {"registers", "stack_bytes",
    "spill_store_bytes", "spill_load_bytes"}} (the second template argument
    of K4's kernel is its team size)."""
    out, cur, mangled, props = {}, None, None, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            mangled, cur = m.group(1), f"{m.group(2)}_l{m.group(3)}"
            if m.group(4):
                cur += f"_s{m.group(4)}"
            out[cur] = {}
        elif "Function properties for" in line:
            props = line.rsplit(" ", 1)[-1]
        elif cur and props == mangled and _FRAME.search(line):
            f = _FRAME.search(line)
            out[cur].update(stack_bytes=int(f.group(1)), spill_store_bytes=int(f.group(2)),
                            spill_load_bytes=int(f.group(3)))
        elif cur and "Used" in line and "registers" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# every entry point ends with: limbs, consts, stream
_TAIL = [_I, _VP, _VP]
_ARGTYPES = {
    # a, b, out, n, a_bcast, b_bcast
    "mont_mul": [_VP, _VP, _VP, _LL, _I, _I] + _TAIL,
    # e, o, w, out_e, out_o, n
    "ntt_butterfly": [_VP, _VP, _VP, _VP, _VP, _LL] + _TAIL,
    # x, tw, out, logm, B, cols_per_block
    "ntt_columns": [_VP, _VP, _VP, _I, _LL, _I] + _TAIL,
    # x1 y1 z1 x2 y2 z2 ox oy oz, n, p_bcast, q_bcast
    "ec_add": [_VP] * 9 + [_LL, _I, _I] + _TAIL,
    # x y z (updated in place), rows, valid, n
    "ec_madd": [_VP] * 5 + [_LL] + _TAIL,
    # x y z (updated in place), rows, neg, valid, n
    "ec_wave_add": [_VP] * 6 + [_LL] + _TAIL,
    # in[12], out[6] (host arrays of device pointers), n, p_bcast, q_bcast
    "ec_add_g2": [_VP, _VP, _LL, _I, _I] + _TAIL,
    # acc[6] (host array of device pointers, updated in place), rows, neg, valid, n
    "ec_wave_add_g2": [_VP] * 4 + [_LL] + _TAIL,
}


def _lib(name: str):
    lib = _libs.get(name)
    if lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDA kernel {name!r} needs a card: none is available and "
                "there is no fallback (CPU tensors take the plain version)")
        path = build_all() / f"lib{name}.so"
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                fn = getattr(lib, f"cc_{name}")
                fn.argtypes = _ARGTYPES[name]
                fn.restype = ctypes.c_int
                _libs[name] = lib
    return getattr(lib, f"cc_{name}")


def load_all() -> None:
    for k in KERNELS:
        _lib(k)


# ---------------------------------------------------------------- wrappers

def _check(name: str, t: torch.Tensor, what: str) -> int:
    """Raise unless `t` is a CUDA int32 limb tensor; returns its limb count."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: {what} must be a CUDA tensor")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: {what} must be int32, got {t.dtype}")
    if t.dim() < 1 or t.shape[0] not in LIMBS:
        raise ValueError(f"{name}: {what} must have {LIMBS[0]} or {LIMBS[1]} limbs on axis 0")
    return t.shape[0]


def _same_limbs(name: str, counts) -> int:
    counts = set(counts)
    if len(counts) != 1:
        raise ValueError(f"{name}: operands differ in limb count: {sorted(counts)}")
    return counts.pop()


def _consts_ptr(name: str, consts, limbs: int) -> int:
    if len(consts) != 3 * limbs + 1:
        raise ValueError(f"{name}: the constant block is not that of a {limbs}-limb field")
    return ctypes.addressof(consts)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _on(device: torch.device):
    """Context that makes `device` current for a launch; free when it
    already is (switching costs more than a small kernel)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _launch(name: str, limbs: int, consts, device, *args) -> None:
    """Launch cc_<name> on `device`'s current stream with the common tail
    (limbs, consts, stream); raise on a refused launch; count it."""
    cptr = _consts_ptr(name, consts, limbs)
    with _on(device):
        err = _lib(name)(*args, limbs, cptr, _stream())
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    _count(count_key(name, limbs))


def _flat_or_single(t, batch):
    """(pointer-ready tensor, broadcast flag): a size-1 batch is passed once
    and broadcast inside the kernel; anything else is expanded."""
    L = t.shape[0]
    n = 1
    for d in batch:
        n *= d
    if t.numel() == L and n != 1:
        return t.reshape(L).contiguous(), 1
    if tuple(t.shape[1:]) != tuple(batch):
        extra = len(batch) - (t.dim() - 1)
        t = t.reshape((L,) + (1,) * extra + tuple(t.shape[1:])).expand((L,) + tuple(batch))
    return t.contiguous(), 0


def mont_mul(a: torch.Tensor, b: torch.Tensor, consts) -> torch.Tensor:
    """a*b*R^-1 mod p elementwise over broadcast (L, *batch) limbs."""
    L = _same_limbs("mont_mul", (_check("mont_mul", a, "a"), _check("mont_mul", b, "b")))
    batch = broadcast_shapes(a.shape[1:], b.shape[1:])
    a2, a_bc = _flat_or_single(a, batch)
    b2, b_bc = _flat_or_single(b, batch)
    out = torch.empty((L,) + tuple(batch), dtype=torch.int32, device=a.device)
    n = out.numel() // L
    if n:
        _launch("mont_mul", L, consts, a.device, a2.data_ptr(), b2.data_ptr(),
                out.data_ptr(), n, a_bc, b_bc)
    return out


def ntt_butterfly(e, o, w, consts):
    """One radix-2 stage on (L, n) limbs: (e + o w, e - o w) mod p."""
    for t, what in ((e, "e"), (o, "o"), (w, "w")):
        _check("ntt_butterfly", t, what)
        if t.dim() != 2 or t.shape != e.shape or not t.is_contiguous():
            raise ValueError("ntt_butterfly: e, o, w must be contiguous (L, n) "
                             "tensors of one shape")
    oe = torch.empty_like(e)
    oo = torch.empty_like(e)
    L, n = e.shape
    if n:
        _launch("ntt_butterfly", L, consts, e.device, e.data_ptr(), o.data_ptr(),
                w.data_ptr(), oe.data_ptr(), oo.data_ptr(), n)
    return oe, oo


NTT_COLUMNS_MAX_LOG = 10
_SMEM_BUDGET = 128 * 1024


def ntt_columns(x, tw, consts):
    """2^m-point NTT (1 <= m <= 10) along axis 1 of (L, M, B) limbs, natural
    order in and out; tw is (L, M/2): the powers w^0..w^(M/2-1)."""
    _check("ntt_columns", x, "x")
    _check("ntt_columns", tw, "tw")
    if x.dim() != 3 or not x.is_contiguous() or not tw.is_contiguous():
        raise ValueError("ntt_columns: x must be contiguous (L, M, B)")
    L, M, B = x.shape
    logm = M.bit_length() - 1
    if (1 << logm) != M or not 1 <= logm <= NTT_COLUMNS_MAX_LOG:
        raise ValueError(f"ntt_columns: M={M} must be a power of two in [2, 1024]")
    if tuple(tw.shape) != (L, M // 2):
        raise ValueError("ntt_columns: tw must be (L, M/2)")
    cb = 8
    while cb > 1 and (cb * M * L * 4 > _SMEM_BUDGET or cb > B):
        cb //= 2
    out = torch.empty_like(x)
    if B:
        _launch("ntt_columns", L, consts, x.device, x.data_ptr(), tw.data_ptr(),
                out.data_ptr(), logm, B, cb)
    return out


def _coords(name, pt, batch):
    """(pointer-ready coordinates, broadcast flag, limb count) of one point."""
    out, flag, limbs = [], None, []
    for c in pt:
        limbs.append(_check(name, c, "coordinate"))
        c2, bc = _flat_or_single(c, batch)
        if flag is not None and bc != flag:
            raise ValueError(f"{name}: coordinates of one point differ in shape")
        flag = bc
        out.append(c2)
    return out, flag, _same_limbs(name, limbs)


def ec_add(p, q, consts):
    """Complete projective G1 add on 3 x (L, *batch) coordinate tensors; a
    single point on either side is broadcast.  Returns (X3, Y3, Z3)."""
    batch = broadcast_shapes(p[0].shape[1:], q[0].shape[1:])
    pc, p_bc, lp = _coords("ec_add", p, batch)
    qc, q_bc, lq = _coords("ec_add", q, batch)
    L = _same_limbs("ec_add", (lp, lq))
    dev = pc[0].device
    outs = [torch.empty((L,) + tuple(batch), dtype=torch.int32, device=dev)
            for _ in range(3)]
    n = outs[0].numel() // L
    if n:
        _launch("ec_add", L, consts, dev, *(c.data_ptr() for c in pc),
                *(c.data_ptr() for c in qc), *(o.data_ptr() for o in outs), n, p_bc, q_bc)
    return tuple(outs)


def ec_add_g2(p, q, consts):
    """Complete projective G2 add: every coordinate is a pair (c0, c1) of
    (L, *batch) tensors over Fq2; a single point on either side is
    broadcast.  Returns ((X0, X1), (Y0, Y1), (Z0, Z1))."""
    batch = broadcast_shapes(p[0][0].shape[1:], q[0][0].shape[1:])
    pc, p_bc, lp = _coords("ec_add_g2", [c for pair in p for c in pair], batch)
    qc, q_bc, lq = _coords("ec_add_g2", [c for pair in q for c in pair], batch)
    L = _same_limbs("ec_add_g2", (lp, lq))
    dev = pc[0].device
    outs = [torch.empty((L,) + tuple(batch), dtype=torch.int32, device=dev)
            for _ in range(6)]
    n = outs[0].numel() // L
    if n:
        ins = (ctypes.c_void_p * 12)(*(c.data_ptr() for c in pc + qc))
        outp = (ctypes.c_void_p * 6)(*(o.data_ptr() for o in outs))
        _launch("ec_add_g2", L, consts, dev, ctypes.addressof(ins), ctypes.addressof(outp),
                n, p_bc, q_bc)
    return ((outs[0], outs[1]), (outs[2], outs[3]), (outs[4], outs[5]))


def _wave_lanes(name: str, acc, coords: int, rows, row_coords: int, masks: dict) -> tuple:
    """(limb count, lanes) of a wave kernel's operands: `coords` contiguous
    int32 (L, *batch) accumulator tensors that it updates in place, rows of
    `row_coords` L words a lane, and (n,) bool masks.  Shapes first, so that
    a wrong one is named as such wherever the tensors lie; then the card."""
    if len(acc) != coords:
        raise ValueError(f"{name}: acc must be {coords} coordinate tensors")
    a0 = acc[0]
    if a0.dim() < 1 or a0.shape[0] not in LIMBS:
        raise ValueError(f"{name}: acc must have {LIMBS[0]} or {LIMBS[1]} limbs on axis 0")
    for c in acc:
        if c.dtype != torch.int32 or not c.is_contiguous() or c.shape != a0.shape:
            raise ValueError(f"{name}: acc coordinates must be contiguous int32 tensors and alike")
    L = a0.shape[0]
    n = a0.numel() // L
    if rows.dtype != torch.int32 or not rows.is_contiguous() \
            or tuple(rows.shape) != (n, row_coords * L) or rows.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be a contiguous, 16-byte aligned int32 "
                         f"({n}, {row_coords * L}) tensor")
    for what, mask in masks.items():
        if mask.dtype != torch.bool or mask.numel() != n or not mask.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous bool tensor of {n} lanes")
    for t in (*acc, rows, *masks.values()):
        if not t.is_cuda:
            raise ValueError(f"{name}: every operand must be a CUDA tensor")
    return L, n


def ec_madd(acc, rows, valid, consts):
    """Masked Jacobian += affine, IN PLACE on the three contiguous (L, *batch)
    accumulator tensors.  rows: (n, 2L) int32, row i = [x limbs | y limbs] of
    lane i's affine point ((0, 0) = identity: lane unchanged); valid: (n,)
    bool, False = lane unchanged.  Returns acc."""
    L, n = _wave_lanes("ec_madd", acc, 3, rows, 2, {"valid": valid})
    if n:
        _launch("ec_madd", L, consts, acc[0].device, *(c.data_ptr() for c in acc),
                rows.data_ptr(), valid.data_ptr(), n)
    return acc


def ec_wave_add(acc, rows, neg, valid, consts):
    """Masked complete projective G1 add with per-lane negation, IN PLACE on
    the three contiguous (L, *batch) accumulator tensors:
    acc <- valid ? acc + (neg ? -pt : pt) : acc.  rows: (n, 3L) int32, row i =
    [x | y | z limbs] of lane i's point; neg, valid: (n,) bool.  Returns acc."""
    L, n = _wave_lanes("ec_wave_add", acc, 3, rows, 3, {"neg": neg, "valid": valid})
    if n:
        _launch("ec_wave_add", L, consts, acc[0].device, *(c.data_ptr() for c in acc),
                rows.data_ptr(), neg.data_ptr(), valid.data_ptr(), n)
    return acc


def ec_wave_add_g2(acc, rows, neg, valid, consts):
    """ec_wave_add over G2: acc is the six contiguous (L, *batch) tensors
    (x0, x1, y0, y1, z0, z1), updated IN PLACE; rows (n, 6L) int32, row i =
    [x0 | x1 | y0 | y1 | z0 | z1 limbs] of lane i's point; neg, valid: (n,)
    bool.  Returns acc."""
    L, n = _wave_lanes("ec_wave_add_g2", acc, 6, rows, 6, {"neg": neg, "valid": valid})
    if n:
        ptrs = (ctypes.c_void_p * 6)(*(c.data_ptr() for c in acc))
        _launch("ec_wave_add_g2", L, consts, acc[0].device, ctypes.addressof(ptrs),
                rows.data_ptr(), neg.data_ptr(), valid.data_ptr(), n)
    return acc
