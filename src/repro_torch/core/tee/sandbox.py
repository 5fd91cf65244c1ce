"""Sandboxing of untrusted model-owner code (paper section 5). Port of
``repro/core/tee/sandbox.py``.

The enforced equivalents of the paper's namespaces: a pure-function
contract (the code runs with I/O builtins denied and the OS, process and
network modules unimportable) and fresh state per iteration (the callable
is rebuilt with a fresh globals dict each run). The only channel out of a
handler is the masked contribution the service code builds from what the
code returns. A policy object and an execution harness, not an OS
boundary.

Only imports made by the sandboxed function's own code go through the
guarded ``__import__``: the modules it calls into (``torch.autograd``)
run with their own globals.
"""
from __future__ import annotations

import builtins
import types
from dataclasses import dataclass, field
from typing import Any, Callable

_DENIED_BUILTINS = ("open", "exec", "eval", "compile", "input", "__import__")
_DENIED_MODULES = ("os", "sys", "subprocess", "socket", "shutil", "pathlib",
                   "urllib", "http", "requests")


class SandboxViolation(RuntimeError):
    pass


def _denied(name):
    def fn(*a, **k):
        raise SandboxViolation(f"sandbox denies {name!r} (R1/R2 isolation)")
    return fn


@dataclass
class Sandbox:
    """Executes untrusted data-handling code under the capability policy."""
    allow_modules: tuple = ("torch", "numpy", "math", "functools")
    violations: list = field(default_factory=list)

    def guarded_import(self, name, *args, **kwargs):
        root = name.split(".")[0]
        if root in _DENIED_MODULES:
            self.violations.append(name)
            raise SandboxViolation(f"import of {name!r} denied inside sandbox")
        return _REAL_IMPORT(name, *args, **kwargs)

    def _restricted_builtins(self) -> dict:
        ns = dict(vars(builtins))
        for name in _DENIED_BUILTINS:
            ns[name] = _denied(name)
        ns["__import__"] = self.guarded_import
        return ns

    def run(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run ``fn`` with I/O capabilities denied. CPython binds a
        function's builtins when it is created, so the callable is rebuilt
        with a fresh globals dict carrying the restricted builtins."""
        g = getattr(fn, "__globals__", None)
        if g is None:  # builtin / C callable: nothing to capture
            return fn(*args, **kwargs)
        sandbox_globals = dict(g)
        sandbox_globals["__builtins__"] = self._restricted_builtins()
        boxed = types.FunctionType(fn.__code__, sandbox_globals,
                                   fn.__name__, fn.__defaults__, fn.__closure__)
        boxed.__kwdefaults__ = getattr(fn, "__kwdefaults__", None)
        return boxed(*args, **kwargs)


_REAL_IMPORT = builtins.__import__
