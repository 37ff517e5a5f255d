"""Lazy builder, loader and wrappers of the hand-written CUDA kernels.

The sources live in ``cocircom_tpu_torch/csrc`` (one ``.cu`` per kernel over
the shared headers ``field.cuh``, ``curve.cuh`` and ``ntt.cuh``).  Every kernel is a
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
           "ec_add_g2", "ec_wave_add_g2", "field_add")
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
    "field_add": None,
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
    "spill_store_bytes", "spill_load_bytes"}} (the second template argument:
    K4's team size, the NTT kernels' elements a thread)."""
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
    # a, tw, scale (or null), out, logn
    "ntt_butterfly": [_VP, _VP, _VP, _VP, _I] + _TAIL,
    # x, tw, post (or null), out, logm, V, B, transpose
    "ntt_columns": [_VP, _VP, _VP, _VP, _I, _LL, _LL, _I] + _TAIL,
    # x1 y1 z1 x2 y2 z2 ox oy oz, n, p_bcast, q_bcast
    "ec_add": [_VP] * 9 + [_LL, _I, _I] + _TAIL,
    # x y z (updated in place), table, astart, aend, m_tab, nw, kp1, t, wt
    "ec_madd": [_VP] * 6 + [_LL, _I, _I, _I, _LL] + _TAIL,
    # x y z (updated in place), pts, order, sortedb, digits, bucket_start, n, nw, kp1, t, wt
    "ec_wave_add": [_VP] * 8 + [_LL, _I, _I, _I, _LL] + _TAIL,
    # in[12], out[6] (host arrays of device pointers), n, p_bcast, q_bcast
    "ec_add_g2": [_VP, _VP, _LL, _I, _I] + _TAIL,
    # acc[6] (host array of device pointers, updated in place), rows, neg, valid, n
    "ec_wave_add_g2": [_VP] * 4 + [_LL] + _TAIL,
    # a, b, out, n, a_bcast, b_bcast, sub
    "field_add": [_VP, _VP, _VP, _LL, _I, _I, _I] + _TAIL,
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


def field_add(a: torch.Tensor, b: torch.Tensor, consts, sub: bool = False) -> torch.Tensor:
    """a + b (or a - b) mod p elementwise over broadcast (L, *batch) limbs."""
    L = _same_limbs("field_add", (_check("field_add", a, "a"), _check("field_add", b, "b")))
    batch = broadcast_shapes(a.shape[1:], b.shape[1:])
    a2, a_bc = _flat_or_single(a, batch)
    b2, b_bc = _flat_or_single(b, batch)
    out = torch.empty((L,) + tuple(batch), dtype=torch.int32, device=a.device)
    n = out.numel() // L
    if n:
        _launch("field_add", L, consts, a.device, a2.data_ptr(), b2.data_ptr(),
                out.data_ptr(), n, a_bc, b_bc, int(sub))
    return out


def _log2_size(name: str, n: int, top: int) -> int:
    """log2 of n, which must be a power of two in [2, 2^top]."""
    logn = n.bit_length() - 1
    if (1 << logn) != n or not 1 <= logn <= top:
        raise ValueError(f"{name}: size {n} must be a power of two in [2, {1 << top}]")
    return logn


def _limbs_like(name: str, t, what: str, L: int, shape) -> None:
    """Raise unless `t` is a contiguous CUDA int32 tensor of `shape` with L limbs."""
    if _check(name, t, what) != L or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous {tuple(shape)} tensor")


NTT_SMALL_MAX_LOG = 11


def ntt_butterfly(a, tw, consts, scale=None):
    """Whole NTT of (L, n) limbs, n = 2^m <= 2^11, natural order in and out,
    in one launch; tw (L, n/2) = w^0..w^(n/2-1); every output times `scale`
    ((L, 1): the 1/n of an inverse transform) when given."""
    L = _check("ntt_butterfly", a, "a")
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError("ntt_butterfly: a must be a contiguous (L, n) tensor")
    logn = _log2_size("ntt_butterfly", a.shape[1], NTT_SMALL_MAX_LOG)
    _limbs_like("ntt_butterfly", tw, "tw", L, (L, a.shape[1] // 2))
    if scale is not None:
        _limbs_like("ntt_butterfly", scale, "scale", L, (L, 1))
    out = torch.empty_like(a)
    _launch("ntt_butterfly", L, consts, a.device, a.data_ptr(), tw.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(), logn)
    return out


NTT_COLUMNS_MAX_LOG = 10


def ntt_columns(x, tw, consts, post=None, transpose: bool = False):
    """One four-step pass: the 2^m-point NTT (1 <= m <= 10) of every column
    of x (L, U, V*B), natural order in and out, tw (L, U/2) = w^0..w^(U/2-1);
    then, when given, output (k1, v, b) times post[k1, v] (post (L, U, V);
    without it V = 1); then, with `transpose`, stored as (L, V, U*B) with
    element (k1, v, b) at [v, k1*B + b]."""
    L = _check("ntt_columns", x, "x")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("ntt_columns: x must be a contiguous (L, U, V*B) tensor")
    _, M, cols = x.shape
    logm = _log2_size("ntt_columns", M, NTT_COLUMNS_MAX_LOG)
    _limbs_like("ntt_columns", tw, "tw", L, (L, M // 2))
    V = post.shape[2] if post is not None and post.dim() == 3 else 1
    if V < 1 or cols % V:
        raise ValueError(f"ntt_columns: {cols} columns are not V*B for V={V}")
    if post is not None:
        _limbs_like("ntt_columns", post, "post", L, (L, M, V))
    B = cols // V
    out = torch.empty((L, V, M * B) if transpose else (L, M, cols), dtype=torch.int32,
                      device=x.device)
    if cols:
        _launch("ntt_columns", L, consts, x.device, x.data_ptr(), tw.data_ptr(),
                None if post is None else post.data_ptr(), out.data_ptr(), logm, V, B,
                int(transpose))
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


def _acc_lanes(name: str, acc, coords: int) -> tuple:
    """(limb count, lanes) of `coords` contiguous int32 (L, *batch)
    accumulator tensors that a wave kernel updates in place."""
    if len(acc) != coords:
        raise ValueError(f"{name}: acc must be {coords} coordinate tensors")
    a0 = acc[0]
    if a0.dim() < 1 or a0.shape[0] not in LIMBS:
        raise ValueError(f"{name}: acc must have {LIMBS[0]} or {LIMBS[1]} limbs on axis 0")
    for c in acc:
        if c.dtype != torch.int32 or not c.is_contiguous() or c.shape != a0.shape:
            raise ValueError(f"{name}: acc coordinates must be contiguous int32 tensors and alike")
    return a0.shape[0], a0.numel() // a0.shape[0]


def _wave_operands(name: str, acc, rows, others) -> None:
    """The checks a wave kernel's other operands share, then the card: `rows`
    is (what, tensor, shape) of the int32 point rows, read in 16-byte loads;
    `others` are (what, tensor, dtype, shape) of its index and mask tensors."""
    what, t, shape = rows
    if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != shape \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be a contiguous, 16-byte aligned int32 "
                         f"{shape} tensor")
    for what, t, dtype, shape in others:
        if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be a contiguous {dtype} {shape} tensor")
    for t in (*acc, rows[1], *(o[1] for o in others)):
        if not t.is_cuda:
            raise ValueError(f"{name}: every operand must be a CUDA tensor")


def _wave_geometry(name: str, acc, bounds, w: int) -> tuple:
    """(L, nw, K+1, T) of a G1 wave: the accumulator is (L, nw, K+1, T) and
    the per-bucket table `bounds` (nw, K+1); w T and the lane count must fit
    the kernel's 32-bit lane arithmetic."""
    L, lanes = _acc_lanes(name, acc, 3)
    if acc[0].dim() != 4 or bounds.dim() != 2 or tuple(acc[0].shape[1:3]) != tuple(bounds.shape):
        raise ValueError(f"{name}: acc must be (L, nw, K+1, T) over run bounds of (nw, K+1)")
    nw, kp1, T = acc[0].shape[1:]
    if not 0 <= w * T < 1 << 31 or lanes >= 1 << 31:
        raise ValueError(f"{name}: wave {w} of {lanes} lanes is out of the kernel's range")
    return L, nw, kp1, T


def ec_madd(acc, table, astart, aend, w: int, consts):
    """Mixed-add wave w of the MSM, IN PLACE on the three contiguous Jacobian
    (L, nw, K+1, T) accumulator tensors: lane (window, b, r) adds row
    window M_tab + astart[window, b] + wT + r of `table` where that position
    is below aend[window, b] and b > 0.  table: (nw M_tab, 2L) int32, the
    run-aligned signed affine rows [x | y limbs] ((0, 0) = identity: lane
    unchanged); astart, aend: (nw, K+1) int64.  Returns acc."""
    L, nw, kp1, T = _wave_geometry("ec_madd", acc, astart, w)
    m_tab = table.shape[0] // max(nw, 1) if table.dim() == 2 else -1
    _wave_operands("ec_madd", acc, ("table", table, (nw * m_tab, 2 * L)),
                   [(what, t, torch.int64, (nw, kp1)) for what, t in
                    (("astart", astart), ("aend", aend))])
    if nw * kp1 * T:
        _launch("ec_madd", L, consts, acc[0].device, *(c.data_ptr() for c in acc),
                table.data_ptr(), astart.data_ptr(), aend.data_ptr(), m_tab, nw, kp1, T, w * T)
    return acc


def ec_wave_add(acc, pts_em, order, sortedb, digits, bucket_start, w: int, consts):
    """Complete-add wave w of the MSM (G1), IN PLACE on the three contiguous
    projective (L, nw, K+1, T) accumulator tensors: lane (window, b, r)
    takes sorted position pos = bucket_start[window, b] + wT + r and, where
    pos < n, sortedb[window, pos] == b and b > 0, adds point
    src = order[window, pos] of `pts_em`, negated where digits[window, src]
    < 0.  pts_em: (n, 3L) int32, row i = [x | y | z limbs] of point i; order,
    sortedb, digits: (nw, n) int64; bucket_start: (nw, K+1) int64.  Returns
    acc."""
    L, nw, kp1, T = _wave_geometry("ec_wave_add", acc, bucket_start, w)
    n = pts_em.shape[0] if pts_em.dim() == 2 else -1
    _wave_operands("ec_wave_add", acc, ("pts_em", pts_em, (n, 3 * L)),
                   [(what, t, torch.int64, (nw, n)) for what, t in
                    (("order", order), ("sortedb", sortedb), ("digits", digits))]
                   + [("bucket_start", bucket_start, torch.int64, (nw, kp1))])
    if nw * kp1 * T and n:
        _launch("ec_wave_add", L, consts, acc[0].device, *(c.data_ptr() for c in acc),
                pts_em.data_ptr(), order.data_ptr(), sortedb.data_ptr(), digits.data_ptr(),
                bucket_start.data_ptr(), n, nw, kp1, T, w * T)
    return acc


def ec_wave_add_g2(acc, rows, neg, valid, consts):
    """ec_wave_add over G2: acc is the six contiguous (L, *batch) tensors
    (x0, x1, y0, y1, z0, z1), updated IN PLACE; rows (n, 6L) int32, row i =
    [x0 | x1 | y0 | y1 | z0 | z1 limbs] of lane i's point; neg, valid: (n,)
    bool.  Returns acc."""
    L, n = _acc_lanes("ec_wave_add_g2", acc, 6)
    _wave_operands("ec_wave_add_g2", acc, ("rows", rows, (n, 6 * L)),
                   [("neg", neg, torch.bool, (n,)), ("valid", valid, torch.bool, (n,))])
    if n:
        ptrs = (ctypes.c_void_p * 6)(*(c.data_ptr() for c in acc))
        _launch("ec_wave_add_g2", L, consts, acc[0].device, ctypes.addressof(ptrs),
                rows.data_ptr(), neg.data_ptr(), valid.data_ptr(), n)
    return acc
