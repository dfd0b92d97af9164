"""Hand-written Hopper kernels for the FP8 hot path, their build and wrappers.

The CUDA C++ sources under ``csrc/`` port fourteen Pallas kernels of
``repro.kernels.fp8_quant``, each wrapper here named after the Pallas
kernel it replaces (the rANS pair of ``csrc/rans.cu`` and the fused QAT
matrix products of ``csrc/qat_matmul.cu`` are built into the same library;
their wrappers are in ``kernels.rans`` and ``kernels.fp8_matmul``):

* ``quant_det``                 — ``csrc/quant_det.cu``
* ``quant_det_bwd``             — ``csrc/quant_det_bwd.cu``
* ``quant_pack_tiles``          — ``csrc/quant_pack.cu``
* ``unpack_tiles``              — ``csrc/unpack.cu``
* ``fake_quant_tiles``          — ``csrc/fake_quant.cu`` (``fake_quant_many``: G clips)
* ``quant_rand``                — ``csrc/quant_rand.cu``
* ``quant_rand_bwd``            — ``csrc/quant_rand.cu``
* ``quant_pack_sub_tiles``      — ``csrc/quant_pack_sub.cu`` (``quant_pack_sub_many``: P planes)
* ``unpack_sub_tiles``          — ``csrc/unpack.cu`` (``unpack_sub_many``: P planes)
* ``quant_pack_amax_tiles``     — ``csrc/quant_pack_amax.cu`` (``quant_pack_amax_many``: P planes)
* ``quant_pack_sub_amax_tiles`` — ``csrc/quant_pack_amax.cu`` (the same, at FP4)
* ``fake_quant_amax_tiles``     — ``csrc/fake_quant.cu``
* ``quant_det_tiles``           — ``csrc/quant_det_tiles.cu``
* ``quant_det_tiles_bwd``       — ``csrc/quant_det_tiles.cu``

Build: at first use, ``nvcc`` compiles every source for ``sm_90a`` at once
(one process per source, started together), links one shared library with a
plain C interface into ``build/repro_torch_kernels/`` at the repository root
(git-ignored; named by a hash of the sources and flags, so an edit rebuilds),
and ``ctypes`` loads it. Nothing is built or imported at module import.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` (``quant_det_bwd`` and ``quant_rand_bwd`` also
reuse one zeroed workspace a device, ``_bwd_workspace``), launches on the
current stream, raises if the C function returns a non-zero
``cudaGetLastError()``, and adds one to ``LAUNCHES[name]``. A tensor on
the CPU takes the kernel's plain twin in ``kernels.ref`` instead (that is
how the CPU tests run); any other device raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import ref
from ..core.fp8 import E4M3, FP4_E2M1, FP8Format

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("quant_det.cu", "quant_det_bwd.cu", "quant_pack.cu", "unpack.cu",
           "fake_quant.cu", "quant_rand.cu", "quant_pack_sub.cu", "quant_pack_amax.cu",
           "rans.cu", "qat_matmul.cu", "quant_det_tiles.cu")
HEADERS = ("fp8_common.cuh", "reduce.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

LANE = ref.LANE
KERNELS = ("quant_det", "quant_det_bwd", "quant_pack_tiles", "unpack_tiles",
           "fake_quant_tiles", "quant_rand", "quant_rand_bwd", "quant_pack_sub_tiles",
           "unpack_sub_tiles", "quant_pack_amax_tiles", "quant_pack_sub_amax_tiles",
           "rans_encode", "rans_decode", "qat_matmul", "qat_matmul_dx", "qat_matmul_dw",
           "quant_det_tiles", "quant_det_tiles_bwd", "fake_quant_amax_tiles")
LAUNCHES = dict.fromkeys(KERNELS, 0)

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfp8_quant_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile and link the kernels unless this exact build exists already.

    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory, spills of each kernel).
    """
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / (Path(src).stem + f".{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, _, proc in procs:
        out, err = proc.communicate()
        if verbose and (out or err):
            print(f"[nvcc {src}]\n{out}{err}", end="")
        if proc.returncode != 0:
            failed.append(f"{src}: exit {proc.returncode}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in procs)],
        capture_output=True, text=True,
    )
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_float)
        fmt_args = [i32, i32, f32]
        lib.repro_quant_det.argtypes = [p, p, p, i64, i32, *fmt_args, p]
        lib.repro_quant_det_bwd_workspace.argtypes = []
        lib.repro_quant_det_bwd.argtypes = [p, p, p, p, p, p, i64, i32, *fmt_args, p]
        lib.repro_quant_pack_tiles.argtypes = [p, p, i32, p, p, i64, *fmt_args, p]
        lib.repro_unpack_tiles.argtypes = [p, p, i32, p, i64, *fmt_args, p]
        lib.repro_fake_quant_many.argtypes = [p, p, i32, p, p, i64, i32, *fmt_args, p]
        lib.repro_fake_quant_amax_tiles.argtypes = [p, p, i32, p, p, p, i64, *fmt_args, p]
        lib.repro_quant_det_tiles.argtypes = [p, p, p, i64, *fmt_args, p]
        lib.repro_quant_det_tiles_bwd.argtypes = [p, p, p, p, p, i64, *fmt_args, p]
        u32 = ctypes.c_uint32
        lib.repro_quant_rand.argtypes = [p, p, p, p, u32, p, i64, *fmt_args, p]
        lib.repro_quant_rand_bwd.argtypes = [p, p, p, p, u32, p, p, p, p, i64, *fmt_args, p]
        lib.repro_quant_pack_sub_many.argtypes = [p, p, i32, p, p, i64, i64, i32, *fmt_args,
                                                  p]
        lib.repro_unpack_sub_many.argtypes = [p, p, i32, p, i64, i32, *fmt_args, p]
        lib.repro_quant_pack_amax_many.argtypes = [p, p, i32, i64, p, p, p, i64, i64, i32,
                                                   *fmt_args, p]
        lib.repro_rans_encode.argtypes = [p, i64, i64, i64, i32, p, p, p, p, p]
        lib.repro_rans_decode.argtypes = [p, i64, p, p, i64, i64, i32, p, p, p, p, p]
        lib.repro_rans_chain.argtypes = [i32, i64, p, p, p, p, p, p]
        lib.repro_qat_matmul_scratch.argtypes = [i32, i32, i32, i32]
        lib.repro_qat_matmul_scratch.restype = ctypes.c_longlong
        lib.repro_qat_matmul.argtypes = [p, p, p, p, p, p, i32, i32, i32, *fmt_args, p]
        lib.repro_qat_matmul_dx.argtypes = [p, p, p, p, p, p, p, p, i32, i32, i32,
                                            *fmt_args, p]
        lib.repro_qat_matmul_dw.argtypes = lib.repro_qat_matmul_dx.argtypes
        for fn in (lib.repro_quant_det, lib.repro_quant_det_bwd_workspace,
                   lib.repro_quant_det_bwd, lib.repro_quant_pack_tiles,
                   lib.repro_unpack_tiles, lib.repro_fake_quant_many,
                   lib.repro_quant_rand, lib.repro_quant_rand_bwd,
                   lib.repro_quant_pack_sub_many, lib.repro_unpack_sub_many,
                   lib.repro_quant_pack_amax_many, lib.repro_rans_encode,
                   lib.repro_rans_decode, lib.repro_rans_chain, lib.repro_qat_matmul,
                   lib.repro_qat_matmul_dx,
                   lib.repro_qat_matmul_dw, lib.repro_fake_quant_amax_tiles,
                   lib.repro_quant_det_tiles, lib.repro_quant_det_tiles_bwd):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# wrapper plumbing
# ---------------------------------------------------------------------------


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {devs}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple | None = None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_io(t: torch.Tensor, name: str) -> int:
    """A QAT operand: f32 or bf16, contiguous. Returns the kernels' bf16 flag."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: expected torch.float32 or torch.bfloat16, got {t.dtype}")
    _check(t, name, t.dtype)
    return int(t.dtype == torch.bfloat16)


def _check_plane(x2: torch.Tensor, a_col: torch.Tensor, name: str = "x2") -> None:
    """A ``(R, 1024)`` f32 plane (16-byte aligned: the B7 kernels load
    float4) with its ``(R, 1)`` f32 alpha column."""
    _check(x2, name, torch.float32)
    if x2.dim() != 2 or x2.shape[1] != LANE:
        raise ValueError(f"{name}: plane must be (R, {LANE}), got {tuple(x2.shape)}")
    if x2.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
    _check(a_col, "alpha column", torch.float32, (x2.shape[0], 1))


def _check_alpha_tiles(x2: torch.Tensor, a2: torch.Tensor) -> int:
    if x2.dim() != 2 or x2.shape[1] != LANE:
        raise ValueError(f"tiles must be (R, {LANE}), got {tuple(x2.shape)}")
    return _check_alpha_rows(x2.shape[0], a2)


def _check_alpha_rows(rows: int, a2: torch.Tensor) -> int:
    """An ``(R, 1)`` or ``(R, 1024)`` f32 alpha of ``rows`` rows; returns its columns."""
    if a2.dim() != 2 or a2.shape[0] != rows or a2.shape[1] not in (1, LANE):
        raise ValueError(f"alpha must be (R, 1) or (R, {LANE}), got {tuple(a2.shape)}")
    _check(a2, "alpha", torch.float32)
    return int(a2.shape[1])


def _check_aligned(t: torch.Tensor, name: str) -> None:
    """A kernel operand it loads in 16-byte vectors."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _fmt_args(fmt: FP8Format):
    return fmt.exp, fmt.mant, fmt.mant_const


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launched(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check_scalar_alpha(alpha: torch.Tensor) -> None:
    _check(alpha, "alpha", torch.float32)
    if alpha.numel() != 1:
        raise ValueError(f"alpha must hold one value, got shape {tuple(alpha.shape)}")


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def quant_det(x: torch.Tensor, alpha: torch.Tensor,
              fmt: FP8Format = E4M3) -> torch.Tensor:
    """Q_det fake-quant of any-shape f32 or bf16 ``x`` with a one-element
    f32 ``alpha``: computed in f32, returned in ``x.dtype``."""
    if _on_cpu(x, alpha):
        return ref.quant_det(x, alpha, fmt)
    bf16 = _check_io(x, "x")
    _check_scalar_alpha(alpha)
    out = torch.empty_like(x)
    rc = load().repro_quant_det(x.data_ptr(), alpha.data_ptr(), out.data_ptr(),
                                x.numel(), bf16, *_fmt_args(fmt), _stream())
    _launched(rc, "quant_det")
    return out


def quant_det_bwd(x: torch.Tensor, alpha: torch.Tensor, g: torch.Tensor,
                  fmt: FP8Format = E4M3):
    """STE backward of :func:`quant_det`: ``(gx, g_alpha)``; ``g`` and ``gx``
    in ``x.dtype`` (f32 or bf16), g_alpha 0-dim f32."""
    if _on_cpu(x, alpha, g):
        return ref.quant_det_bwd(x, alpha, g, fmt)
    bf16 = _check_io(x, "x")
    _check(g, "g", x.dtype, tuple(x.shape))
    _check_scalar_alpha(alpha)
    lib = load()
    gx = torch.empty_like(x)
    ga = torch.empty((), dtype=torch.float32, device=x.device)
    rc = lib.repro_quant_det_bwd(
        x.data_ptr(), alpha.data_ptr(), g.data_ptr(), gx.data_ptr(),
        _bwd_workspace(x.device).data_ptr(), ga.data_ptr(), x.numel(), bf16,
        *_fmt_args(fmt), _stream())
    _launched(rc, "quant_det_bwd")
    return gx, ga


_WORKSPACES: dict = {}


def _bwd_workspace(device: torch.device) -> torch.Tensor:
    """The workspace of B2 and B6's backward on ``device``, allocated and
    zeroed at its first call: a ticket word that every launch leaves at 0,
    then the block partials (``csrc/reduce.cuh``). Calls on one stream share
    it; it assumes no two such launches on one device overlap in time (one
    stream, no graph replays running concurrently)."""
    ws = _WORKSPACES.get(device)
    if ws is None:
        ws = torch.zeros(load().repro_quant_det_bwd_workspace(), dtype=torch.float32,
                         device=device)
        _WORKSPACES[device] = ws
    return ws


def quant_pack_tiles(x2: torch.Tensor, a2: torch.Tensor,
                     key2: torch.Tensor | None = None,
                     fmt: FP8Format = E4M3) -> torch.Tensor:
    """Quantize + pack ``(R, 1024)`` f32 tiles to u8 codes; ``key2`` is a
    ``(2,)`` u32 key for stochastic rounding, None for deterministic."""
    if _on_cpu(x2, a2, key2):
        return ref.quant_pack_tiles(x2, a2, key2, fmt)
    _check(x2, "x2", torch.float32)
    a_cols = _check_alpha_tiles(x2, a2)
    if key2 is not None:
        _check(key2, "key2", torch.uint32, (2,))
    out = torch.empty(x2.shape, dtype=torch.uint8, device=x2.device)
    rc = load().repro_quant_pack_tiles(
        x2.data_ptr(), a2.data_ptr(), a_cols, _ptr(key2), out.data_ptr(),
        x2.numel(), *_fmt_args(fmt), _stream())
    _launched(rc, "quant_pack_tiles")
    return out


def unpack_tiles(c2: torch.Tensor, a2: torch.Tensor,
                 fmt: FP8Format = E4M3) -> torch.Tensor:
    """Decode ``(R, 1024)`` u8 codes to f32 grid values."""
    if _on_cpu(c2, a2):
        return ref.unpack_tiles(c2, a2, fmt)
    _check(c2, "c2", torch.uint8)
    a_cols = _check_alpha_tiles(c2, a2)
    out = torch.empty(c2.shape, dtype=torch.float32, device=c2.device)
    rc = load().repro_unpack_tiles(c2.data_ptr(), a2.data_ptr(), a_cols,
                                   out.data_ptr(), c2.numel(), *_fmt_args(fmt),
                                   _stream())
    _launched(rc, "unpack_tiles")
    return out


def fake_quant_tiles(x2: torch.Tensor, a2: torch.Tensor,
                     key2: torch.Tensor | None = None,
                     fmt: FP8Format = E4M3) -> torch.Tensor:
    """Quantize -> dequantize ``(R, 1024)`` f32 tiles to f32 grid values (no
    codes); ``key2`` is a ``(2,)`` u32 key for stochastic rounding from the
    counter RNG, None for deterministic. ``a2`` is ``(R, 1)`` or ``(R, 1024)``.
    The G = 1 launch of :func:`fake_quant_many`."""
    if _on_cpu(x2, a2, key2):
        return ref.fake_quant_tiles(x2, a2, key2, fmt)
    _check(x2, "x2", torch.float32)
    _check_alpha_tiles(x2, a2)
    if key2 is not None:
        _check(key2, "key2", torch.uint32, (2,))
    return _fake_quant_many(x2, a2[None], None if key2 is None else key2[None], fmt)[0]


def fake_quant_many(x2: torch.Tensor, a3: torch.Tensor,
                    keys: torch.Tensor | None = None,
                    fmt: FP8Format = E4M3) -> torch.Tensor:
    """One plane at G clips in one launch: ``(R, 1024)`` f32 tiles, alphas
    ``(G, R, 1)`` or ``(G, R, 1024)``, ``keys`` ``(G, 2)`` u32 (None:
    deterministic) -> ``(G, R, 1024)`` f32; slice g is bitwise
    ``fake_quant_tiles(x2, a3[g], keys[g])``."""
    if _on_cpu(x2, a3, keys):
        return ref.fake_quant_tiles_many(x2, a3, keys, fmt)
    _check(x2, "x2", torch.float32)
    if a3.dim() != 3:
        raise ValueError(f"alpha must be (G, R, 1) or (G, R, {LANE}), got {tuple(a3.shape)}")
    _check_alpha_tiles(x2, a3[0])
    _check(a3, "alpha", torch.float32)
    if keys is not None:
        _check(keys, "keys", torch.uint32, (a3.shape[0], 2))
    return _fake_quant_many(x2, a3, keys, fmt)


def _fake_quant_many(x2, a3, keys, fmt) -> torch.Tensor:
    out = torch.empty((a3.shape[0], *x2.shape), dtype=torch.float32, device=x2.device)
    rc = load().repro_fake_quant_many(
        x2.data_ptr(), a3.data_ptr(), int(a3.shape[2]), _ptr(keys), out.data_ptr(),
        x2.numel(), a3.shape[0], *_fmt_args(fmt), _stream())
    _launched(rc, "fake_quant_tiles")
    return out


def _rand_bits(x: torch.Tensor, bits) -> tuple:
    """B6's bits arguments ``(bits pointer, key pointer, mix)``: u32 ``bits``
    of x's shape read by the kernel, or a ``ref.CounterKey`` whose bits the
    kernel draws from its two key words on the device and the site's word."""
    if isinstance(bits, ref.CounterKey):
        _check(bits.key2, "key2", torch.uint32, (2,))
        return None, bits.key2.data_ptr(), bits.mix
    _check(bits, "bits", torch.uint32, tuple(x.shape))
    return bits.data_ptr(), None, 0


def _bits_tensor(bits) -> torch.Tensor:
    return bits.key2 if isinstance(bits, ref.CounterKey) else bits


def quant_rand(x: torch.Tensor, alpha: torch.Tensor, bits,
               fmt: FP8Format = E4M3) -> torch.Tensor:
    """Q_rand fake-quant of any-shape f32 ``x`` with a one-element ``alpha``;
    ``bits`` are u32 random bits of x's shape, or a ``ref.CounterKey`` (the
    kernel draws the site's counter bits itself)."""
    if _on_cpu(x, alpha, _bits_tensor(bits)):
        return ref.quant_rand(x, alpha, bits, fmt)
    _check(x, "x", torch.float32)
    _check_scalar_alpha(alpha)
    bits_p, key_p, mix = _rand_bits(x, bits)
    out = torch.empty_like(x)
    rc = load().repro_quant_rand(x.data_ptr(), alpha.data_ptr(), bits_p, key_p, mix,
                                 out.data_ptr(), x.numel(), *_fmt_args(fmt), _stream())
    _launched(rc, "quant_rand")
    return out


def quant_rand_bwd(x: torch.Tensor, alpha: torch.Tensor, bits,
                   g: torch.Tensor, fmt: FP8Format = E4M3):
    """STE backward of :func:`quant_rand` (the same bits or key): ``(gx,
    g_alpha)``, g_alpha 0-dim; one launch, through B2's workspace."""
    if _on_cpu(x, alpha, _bits_tensor(bits), g):
        return ref.quant_rand_bwd(x, alpha, bits, g, fmt)
    _check(x, "x", torch.float32)
    _check(g, "g", torch.float32, tuple(x.shape))
    _check_scalar_alpha(alpha)
    bits_p, key_p, mix = _rand_bits(x, bits)
    gx = torch.empty_like(x)
    ga = torch.empty((), dtype=torch.float32, device=x.device)
    rc = load().repro_quant_rand_bwd(
        x.data_ptr(), alpha.data_ptr(), bits_p, key_p, mix, g.data_ptr(), gx.data_ptr(),
        _bwd_workspace(x.device).data_ptr(), ga.data_ptr(), x.numel(), *_fmt_args(fmt),
        _stream())
    _launched(rc, "quant_rand_bwd")
    return gx, ga


def _sub_codes(fmt: FP8Format) -> int:
    """Codes per byte of a sub-byte ``fmt`` (2 for FP4); raises otherwise."""
    k = ref.codes_per_byte(fmt)
    if k == 1:
        raise ValueError(f"{fmt.bits}-bit codes take one byte each: the sub-byte "
                         "kernels are for formats of fewer bits (FP4)")
    return k


def quant_pack_sub_tiles(x2: torch.Tensor, a2: torch.Tensor,
                         key2: torch.Tensor | None = None,
                         fmt: FP8Format = FP4_E2M1) -> torch.Tensor:
    """Quantize + pack ``(R, 1024)`` f32 tiles at ``8 // fmt.bits`` codes per
    byte -> ``(R, 1024 // k)`` u8 (FP4: code 2j in the low nibble of byte j);
    ``key2`` a ``(2,)`` u32 key for stochastic rounding, None for det. The
    P = 1 launch of :func:`quant_pack_sub_many`."""
    k = _sub_codes(fmt)
    if _on_cpu(x2, a2, key2):
        return ref.quant_pack_sub_tiles(x2, a2, key2, fmt)
    _check(x2, "x2", torch.float32)
    _check_alpha_tiles(x2, a2)
    if key2 is not None:
        _check(key2, "key2", torch.uint32, (2,))
    return _pack_sub_many(x2[None], a2[None], None if key2 is None else key2[None], k, fmt)[0]


def quant_pack_sub_many(x3: torch.Tensor, a3: torch.Tensor,
                        keys: torch.Tensor | None = None,
                        fmt: FP8Format = FP4_E2M1) -> torch.Tensor:
    """A cohort's FP4 encodes in one launch: ``(P, R, 1024)`` f32 tiles,
    alphas ``(P, R, 1)`` or ``(P, R, 1024)``, ``keys`` ``(P, 2)`` u32 (None:
    deterministic) -> ``(P, R, 1024 // k)`` u8; slice p is bitwise
    ``quant_pack_sub_tiles(x3[p], a3[p], keys[p])``."""
    k = _sub_codes(fmt)
    if _on_cpu(x3, a3, keys):
        return ref.quant_pack_sub_tiles_many(x3, a3, keys, fmt)
    _check(x3, "x3", torch.float32)
    if x3.dim() != 3 or a3.dim() != 3 or a3.shape[0] != x3.shape[0]:
        raise ValueError(f"tiles must be (P, R, {LANE}) with alpha (P, R, 1) or (P, R, {LANE}),"
                         f" got {tuple(x3.shape)} and {tuple(a3.shape)}")
    _check_alpha_tiles(x3[0], a3[0])
    _check(a3, "alpha", torch.float32)
    if keys is not None:
        _check(keys, "keys", torch.uint32, (x3.shape[0], 2))
    return _pack_sub_many(x3, a3, keys, k, fmt)


def _pack_sub_many(x3, a3, keys, k: int, fmt) -> torch.Tensor:
    p, rows = x3.shape[0], x3.shape[1]
    out = torch.empty((p, rows, LANE // k), dtype=torch.uint8, device=x3.device)
    rc = load().repro_quant_pack_sub_many(
        x3.data_ptr(), a3.data_ptr(), int(a3.shape[2]), _ptr(keys), out.data_ptr(), p,
        rows * (LANE // k), k, *_fmt_args(fmt), _stream())
    _launched(rc, "quant_pack_sub_tiles")
    return out


def unpack_sub_tiles(c2: torch.Tensor, a2: torch.Tensor,
                     fmt: FP8Format = FP4_E2M1) -> torch.Tensor:
    """Decode ``(R, 1024 // k)`` packed u8 codes to ``(R, 1024)`` f32. The
    P = 1 launch of :func:`unpack_sub_many`."""
    k = _sub_codes(fmt)
    if _on_cpu(c2, a2):
        return ref.unpack_sub_tiles(c2, a2, fmt)
    _check(c2, "c2", torch.uint8)
    if c2.dim() != 2 or c2.shape[1] != LANE // k:
        raise ValueError(f"packed codes must be (R, {LANE // k}), got {tuple(c2.shape)}")
    a_cols = _check_alpha_rows(c2.shape[0], a2)
    out = torch.empty((c2.shape[0], LANE), dtype=torch.float32, device=c2.device)
    return _unpack_sub_launch(c2, a2, a_cols, out, k, fmt)


def unpack_sub_many(c3: torch.Tensor, a3: torch.Tensor,
                    fmt: FP8Format = FP4_E2M1) -> torch.Tensor:
    """A cohort's FP4 decodes in one launch: ``(P, R, 1024 // k)`` packed u8
    codes, alphas ``(P, R, 1)`` or ``(P, R, 1024)`` -> ``(P, R, 1024)`` f32;
    slice p is bitwise ``unpack_sub_tiles(c3[p], a3[p])``."""
    k = _sub_codes(fmt)
    if _on_cpu(c3, a3):
        return ref.unpack_sub_tiles_many(c3, a3, fmt)
    _check(c3, "c3", torch.uint8)
    if c3.dim() != 3 or c3.shape[2] != LANE // k or a3.dim() != 3 or a3.shape[0] != c3.shape[0]:
        raise ValueError(f"packed codes must be (P, R, {LANE // k}) with alpha (P, R, 1) or "
                         f"(P, R, {LANE}), got {tuple(c3.shape)} and {tuple(a3.shape)}")
    _check_alpha_rows(c3.shape[1], a3[0])
    _check(a3, "alpha", torch.float32)
    out = torch.empty((*c3.shape[:2], LANE), dtype=torch.float32, device=c3.device)
    return _unpack_sub_launch(c3, a3, int(a3.shape[2]), out, k, fmt)


def _unpack_sub_launch(c, a, a_cols: int, out, k: int, fmt) -> torch.Tensor:
    """B8's decode of checked codes ``c`` at alphas ``a`` (either rank) into ``out``."""
    if a_cols == LANE:
        _check_aligned(a, "alpha")
    rc = load().repro_unpack_sub_many(c.data_ptr(), a.data_ptr(), a_cols, out.data_ptr(),
                                      c.numel(), k, *_fmt_args(fmt), _stream())
    _launched(rc, "unpack_sub_tiles")
    return out


def quant_pack_amax_tiles(x2: torch.Tensor, a2: torch.Tensor,
                          key2: torch.Tensor | None = None,
                          fmt: FP8Format = E4M3):
    """:func:`quant_pack_tiles` and, from the same launch, the per-row max|x|
    of the raw tiles: ``(codes (R, 1024) u8, rowmax (R, 1) f32)``. The P = 1
    launch of :func:`quant_pack_amax_many`."""
    if ref.codes_per_byte(fmt) != 1:
        raise ValueError(f"{fmt.bits}-bit codes pack several per byte: "
                         "use quant_pack_sub_amax_tiles")
    if _on_cpu(x2, a2, key2):
        return ref.quant_pack_amax_tiles(x2, a2, key2, fmt)
    return _pack_amax_one(x2, a2, key2, 1, fmt)


def quant_pack_sub_amax_tiles(x2: torch.Tensor, a2: torch.Tensor,
                              key2: torch.Tensor | None = None,
                              fmt: FP8Format = FP4_E2M1):
    """:func:`quant_pack_sub_tiles` and, from the same launch, the per-row
    max|x| of the raw tiles: ``(codes (R, 1024 // k) u8, rowmax (R, 1) f32)``.
    The P = 1 launch of :func:`quant_pack_amax_many`."""
    k = _sub_codes(fmt)
    if _on_cpu(x2, a2, key2):
        return ref.quant_pack_sub_amax_tiles(x2, a2, key2, fmt)
    return _pack_amax_one(x2, a2, key2, k, fmt)


def _pack_amax_one(x2, a2, key2, k: int, fmt):
    _check(x2, "x2", torch.float32)
    a_cols = _check_alpha_tiles(x2, a2)
    if key2 is not None:
        _check(key2, "key2", torch.uint32, (2,))
    rows = x2.shape[0]
    codes = torch.empty((rows, LANE // k), dtype=torch.uint8, device=x2.device)
    rowmax = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    return _pack_amax_launch(x2, a2, a_cols, 0, key2, codes, rowmax, 1, k, fmt)


def quant_pack_amax_many(x3: torch.Tensor, a3: torch.Tensor,
                         keys: torch.Tensor | None = None, fmt: FP8Format = E4M3):
    """A cohort's wire encodes with the per-row raw max|x| in one launch:
    ``(P, R, 1024)`` f32 tiles, alphas ``(P, R, 1)`` or ``(P, R, 1024)``
    (``expand`` of one slice, stride 0 over P, is taken as it is), ``keys``
    ``(P, 2)`` u32 (None: det) -> ``(codes (P, R, 1024 // k) u8, rowmax (P,
    R, 1) f32)`` at ``k = 8 // fmt.bits`` codes a byte (FP8 or FP4); slice p
    is bitwise the single launch on ``(x3[p], a3[p], keys[p])``. Counted
    under ``quant_pack_amax_tiles`` (FP8) or ``quant_pack_sub_amax_tiles``."""
    if _on_cpu(x3, a3, keys):
        return ref.quant_pack_amax_tiles_many(x3, a3, keys, fmt)
    k = ref.codes_per_byte(fmt)
    if k > 2:
        raise ValueError(f"{fmt.bits}-bit codes: the amax encodes take 8- or 4-bit formats")
    _check(x3, "x3", torch.float32)
    if x3.dim() != 3 or a3.dim() != 3 or a3.shape[0] != x3.shape[0]:
        raise ValueError(f"tiles must be (P, R, {LANE}) with alpha (P, R, 1) or (P, R, {LANE}),"
                         f" got {tuple(x3.shape)} and {tuple(a3.shape)}")
    a_cols = _check_alpha_tiles(x3[0], a3[0])
    if a3.shape[0] > 1 and a3.stride(0) not in (0, a3[0].numel()):
        raise ValueError("alpha: its slices must be contiguous, or one slice expanded over P")
    if keys is not None:
        _check(keys, "keys", torch.uint32, (x3.shape[0], 2))
    p, rows = x3.shape[0], x3.shape[1]
    codes = torch.empty((p, rows, LANE // k), dtype=torch.uint8, device=x3.device)
    rowmax = torch.empty((p, rows, 1), dtype=torch.float32, device=x3.device)
    return _pack_amax_launch(x3, a3, a_cols, a3.stride(0), keys, codes, rowmax, p, k, fmt)


def _pack_amax_launch(x, a, a_cols: int, a_stride: int, keys, codes, rowmax, p: int, k: int,
                      fmt):
    """B9's amax encode of ``p`` checked planes ``x`` (either rank; slice
    alphas ``a_stride`` floats apart) into ``codes`` and ``rowmax``."""
    _check_aligned(x, "x")
    if a_cols == LANE:
        _check_aligned(a, "alpha")
    rc = load().repro_quant_pack_amax_many(
        x.data_ptr(), a.data_ptr(), a_cols, a_stride, _ptr(keys), codes.data_ptr(),
        rowmax.data_ptr(), p, codes.shape[-2], k, *_fmt_args(fmt), _stream())
    _launched(rc, "quant_pack_amax_tiles" if k == 1 else "quant_pack_sub_amax_tiles")
    return codes, rowmax


def fake_quant_amax_tiles(x2: torch.Tensor, a2: torch.Tensor,
                          key2: torch.Tensor | None = None,
                          fmt: FP8Format = E4M3):
    """:func:`fake_quant_tiles` and, from the same launch, the per-row max|x|
    of the raw tiles: ``(q (R, 1024) f32, rowmax (R, 1) f32)``. The kernel
    loads x, and an ``(R, 1024)`` alpha, in 16-byte vectors: both must be
    16-byte aligned."""
    if _on_cpu(x2, a2, key2):
        return ref.fake_quant_amax_tiles(x2, a2, key2, fmt)
    _check(x2, "x2", torch.float32)
    a_cols = _check_alpha_tiles(x2, a2)
    _check_aligned(x2, "x2")
    if a_cols == LANE:
        _check_aligned(a2, "alpha")
    if key2 is not None:
        _check(key2, "key2", torch.uint32, (2,))
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    rowmax = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    rc = load().repro_fake_quant_amax_tiles(
        x2.data_ptr(), a2.data_ptr(), a_cols, _ptr(key2), out.data_ptr(),
        rowmax.data_ptr(), rows, *_fmt_args(fmt), _stream())
    _launched(rc, "fake_quant_amax_tiles")
    return out, rowmax


def quant_det_tiles(x2: torch.Tensor, a_col: torch.Tensor,
                    fmt: FP8Format = E4M3) -> torch.Tensor:
    """Q_det of the ``(R, 1024)`` f32 parameter plane with its ``(R, 1)``
    per-row alpha column (floored by the caller): f32 grid values."""
    if _on_cpu(x2, a_col):
        return ref.quant_det_tiles(x2, a_col, fmt)
    _check_plane(x2, a_col)
    out = torch.empty_like(x2)
    rc = load().repro_quant_det_tiles(x2.data_ptr(), a_col.data_ptr(), out.data_ptr(),
                                      x2.shape[0], *_fmt_args(fmt), _stream())
    _launched(rc, "quant_det_tiles")
    return out


def quant_det_tiles_bwd(x2: torch.Tensor, a_col: torch.Tensor, g2: torch.Tensor,
                        fmt: FP8Format = E4M3):
    """STE backward of :func:`quant_det_tiles`: ``(gx (R, 1024), ga_row (R, 1))``,
    the clip mask to the plane and each row's clip cotangent, summed over
    the row in a fixed order."""
    if _on_cpu(x2, a_col, g2):
        return ref.quant_det_tiles_bwd(x2, a_col, g2, fmt)
    _check_plane(x2, a_col)
    _check_plane(g2, a_col, "g2")
    rows = x2.shape[0]
    gx = torch.empty_like(x2)
    ga_row = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    rc = load().repro_quant_det_tiles_bwd(
        x2.data_ptr(), a_col.data_ptr(), g2.data_ptr(), gx.data_ptr(), ga_row.data_ptr(),
        rows, *_fmt_args(fmt), _stream())
    _launched(rc, "quant_det_tiles_bwd")
    return gx, ga_row
