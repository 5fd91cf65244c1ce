"""Kernel routing for the port: a minimal twin of ``repro.kernels.dispatch``.

The JAX registry chooses among several implementations per kernel, with
capability fallbacks. The port has exactly two per kernel and the choice is
the tensors' device, nothing else:

* every tensor on a CUDA device -> the hand-written CUDA kernel. A shape,
  dtype or layout the kernel does not take raises; there is no fallback to
  the plain version on CUDA.
* every tensor on the CPU -> the kernel's plain PyTorch version.
* anything else (mixed devices, another backend) raises.

Each kernel is a :class:`Kernel` record holding its launch counter: the
CUDA wrapper adds one where it launches, and nowhere else, so a run can show
that its path went through the kernel. A kernel built in more than one
instantiation also counts each apart (``variants``), so a run can show
which of them its path launched.

Above the tensors, the JAX package's three tree-level kernels choose an
execution policy for a whole gradient tree: ``packed`` (one flat buffer,
one kernel) or ``perleaf`` (one kernel per leaf, another stream family).
:func:`resolve_tree` makes that choice as ``repro.kernels.dispatch`` does,
in precedence order:

1. :func:`force_impl`, a context manager, optionally scoped to one
   tree-level kernel; nested blocks, innermost wins; thread-local;
2. ``REPRO_KERNEL_IMPL``: a bare name (``perleaf``) for the three tree-level
   kernels, or a ``kernel=impl,...`` list
   (``REPRO_KERNEL_IMPL=dp_noise_tree=perleaf``);
3. the call's ``impl``; ``auto`` is ``packed`` for CUDA tensors and
   ``perleaf`` for CPU ones, as JAX's ``prefers_packed`` picks packed on the
   TPU only.

The legacy names map as in ``repro.core.dp_pipeline.resolve_policy``:
``pallas`` is packed, ``jnp`` is perleaf. A bare name that is none of these
is ignored, as JAX ignores a global override a kernel lacks. An override
scoped to a tensor-level kernel (``zsmask``, ``zsmask_buffer``,
``dp_clip_sumsq``, ...) raises ``ValueError``: here the tensors' device
picks a tensor-level route, and on the card such an override could only
select a plain version and hide the kernel. A tree-level scope names a
policy, not a CUDA kernel: ``zsmask_tree`` chooses ``pairwise_mask_tree``'s
route, and no kernel has its name.
"""
from __future__ import annotations

import functools
import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class Kernel:
    """One hand-written CUDA kernel of the port."""

    name: str
    source: str    # the .cu file, relative to the repository root
    replaces: str  # the TPU kernel it ports, file:line in src/repro
    launches: int = 0
    # launches of each instantiation, where there is more than one
    variants: dict[str, int] = field(default_factory=dict)

    def count(self, variant: str, n: int = 1) -> None:
        """``n`` launches of instantiation ``variant``."""
        self.launches += n
        self.variants[variant] += n


KERNELS: dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str,
             variants: tuple = ()) -> Kernel:
    if name in KERNELS:
        raise ValueError(f"kernel {name!r} registered twice")
    KERNELS[name] = Kernel(name, source, replaces,
                           variants=dict.fromkeys(variants, 0))
    return KERNELS[name]


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.variants.update(dict.fromkeys(k.variants, 0))


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def variant_counts() -> dict[str, dict[str, int]]:
    """Launches of each instantiation of the kernels built in more than
    one."""
    return {name: dict(k.variants) for name, k in KERNELS.items()
            if k.variants}


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every tensor
    is on the CPU; raises on a mix or on any other device."""
    n = 0
    for t in tensors:  # the serving step's hot path: no set, no device objects
        n += t.is_cuda
    if n == len(tensors):
        return True
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"meta"} and counting_scope() is not None:
        return True  # to the CUDA wrapper, whose stand-in counts the work
    raise ValueError(f"kernel inputs must all be on cuda or all on cpu, "
                     f"got {sorted(kinds)}")


# ---------------------------------------------------------------------------
# meta tensors: the counting scope of ``analysis/op_cost.py``
#
# The step cost counter runs a cell's step on the meta device. A kernel
# there is counted by its own work formula, never through its plain
# version's ops: inside ``counting(scope)``, ``on_cuda`` routes all-meta
# inputs to the CUDA wrapper, and each wrapper (:func:`countable`) hands
# meta inputs to ``scope.kernel(name, ...)``, which counts the kernel and
# returns meta outputs of its shapes. Outside a scope meta inputs raise,
# as any other device does; a wrapper that is not countable reaches
# ``_build.Entry.launch``, which launches on CUDA devices only.

_scope = None


def counting_scope():
    """The active counting scope, or None."""
    return _scope


@contextmanager
def counting(scope):
    """Route meta tensors to ``scope``'s kernel stand-ins inside the
    block."""
    global _scope
    outer, _scope = _scope, scope
    try:
        yield scope
    finally:
        _scope = outer


def countable(name: str):
    """A CUDA wrapper whose meta inputs go to the counting scope's stand-in
    for kernel ``name`` (its first argument is a tensor)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if args[0].is_meta:
                scope = counting_scope()
                if scope is None:
                    raise ValueError(f"{name}: meta tensors reach a kernel "
                                     f"only inside a counting scope "
                                     f"(analysis.op_cost)")
                return scope.kernel(name, *args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


# head dims the paged attention kernels are instantiated for
# (paged_attention/csrc/paged_attention.cu): the smoke configs' 16, 32 and
# 64, stablelm-3b's 80, phi3-mini-3.8b's 96, qwen2.5-3b's and
# mistral-large-123b's 128; the flash kernel also takes zamba2's 112
# (flash_attention/csrc/flash_attention.cu)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
FLASH_HEAD_DIMS = (16, 32, 64, 80, 96, 112, 128)


# the element types of the attention and page-pool kernels
# (flash_attention/csrc/*.cu, paged_attention/csrc/*.cu), each an
# instantiation that its kernel counts apart
DTYPE_VARIANTS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def dtype_variant(name: str, t: torch.Tensor) -> str:
    """The instantiation that takes ``t``'s dtype; raises for another."""
    v = DTYPE_VARIANTS.get(t.dtype)
    if v is None:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of "
                         f"{list(DTYPE_VARIANTS)}")
    return v


def require(cond: bool, what: str) -> None:
    """A wrapper's check of what its kernel takes: raises ``ValueError``."""
    if not cond:
        raise ValueError(what)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    """Device, dtype, rank and contiguity of one kernel argument (the
    message is built only when the check fails: this runs on every
    launch)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_key(name: str, key) -> tuple:
    """A raw threefry key ``(k0, k1)``: two uint32 words, as ints."""
    k0, k1 = (int(k) for k in key)
    require(0 <= k0 <= 0xFFFFFFFF and 0 <= k1 <= 0xFFFFFFFF,
            f"{name}: key words must be uint32, got {key}")
    return k0, k1


def check_rows(name: str, t: torch.Tensor, device: torch.device) -> int:
    """An fp32 (n, D) argument whose rows are contiguous but may be spaced
    apart (a column range of a wider buffer). Returns the row stride."""
    require(t.device == device, f"{name}: on {t.device}, expected {device}")
    require(t.dtype == torch.float32, f"{name}: dtype {t.dtype}, expected "
                                      f"torch.float32")
    require(t.dim() == 2, f"{name}: {t.dim()}-d, expected 2-d")
    n, D = t.shape
    require(D <= 1 or t.stride(1) == 1, f"{name}: rows must be contiguous")
    ld = t.stride(0) if n > 1 else D
    require(ld >= D, f"{name}: rows overlap (row stride {ld} < {D})")
    return ld


# ---------------------------------------------------------------------------
# tree-level execution policy

ENV_VAR = "REPRO_KERNEL_IMPL"
TREE_KERNELS = ("dp_noise_tree", "zsmask_tree", "dp_clip_tree")
TREE_IMPLS = {"packed": "packed", "perleaf": "perleaf", "pallas": "packed",
              "jnp": "perleaf"}
_local = threading.local()


def _check_scope(kernel: str) -> None:
    if kernel not in TREE_KERNELS:
        raise ValueError(
            f"an override scoped to {kernel!r} is not taken: only the "
            f"tree-level kernels {TREE_KERNELS} choose an implementation; a "
            f"tensor-level kernel runs its CUDA kernel on CUDA tensors and "
            f"its plain version on CPU tensors")


@contextmanager
def force_impl(impl: str, kernel: Optional[str] = None):
    """Force ``impl`` for the tree-level ``kernel`` (for all three when
    None) inside the ``with`` block. Nested blocks: innermost wins."""
    if kernel is not None:
        _check_scope(kernel)
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append((kernel, impl))
    try:
        yield
    finally:
        stack.pop()


def _forced(kernel: str) -> Optional[tuple]:
    """(impl, is_global) from the innermost applicable ``force_impl``."""
    for scope, impl in reversed(getattr(_local, "stack", None) or []):
        if scope is None or scope == kernel:
            return impl, scope is None
    return None


def _env_impl(kernel: str) -> Optional[tuple]:
    """(impl, is_global) from ``REPRO_KERNEL_IMPL``."""
    raw = os.environ.get(ENV_VAR, "").strip()
    if not raw:
        return None
    if "=" not in raw:
        return raw, True
    found = None
    for part in raw.split(","):
        k, _, v = part.partition("=")
        k, v = k.strip(), v.strip()
        if not k:
            continue
        _check_scope(k)
        if k == kernel and v and found is None:  # the first, as JAX reads
            found = (v, False)
    return found


def resolve_tree(kernel: str, impl: str = "auto",
                 cuda: Optional[bool] = None) -> str:
    """``'packed'`` or ``'perleaf'`` for the tree-level ``kernel``, after
    the overrides; ``cuda`` says where the tree lies, for ``auto``."""
    _check_scope(kernel)
    requested = impl
    override = _forced(kernel) or _env_impl(kernel)
    if override is not None:
        name, is_global = override
        if not (is_global and name not in TREE_IMPLS):
            requested = name
    if requested == "auto":
        if cuda is None:
            raise ValueError(f"{kernel}: 'auto' needs the tree's device")
        return "packed" if cuda else "perleaf"
    if requested not in TREE_IMPLS:
        raise ValueError(f"unknown impl {requested!r} for kernel {kernel!r}; "
                         f"available: {sorted(TREE_IMPLS)} or 'auto'")
    return TREE_IMPLS[requested]
