"""FunctionLibrary — the shared-library analogue (paper §5.2).

rFaaS ships a C++ .so at cold start; both sides sort the exported symbols
and invocations carry only the *function index*.  Here a library is a
named bundle of python/JAX callables; registration sorts symbols, and the
wire format (InvocationHeader) carries the index, exactly preserving the
call-by-index protocol.  ``code_size`` models the .so bytes pushed to the
executor during cold start (paper used a 7.88 kB no-op library).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List


@dataclass
class FunctionLibrary:
    name: str
    code_size: int = 7_880          # bytes written at cold start
    version: int = 0                # bumped on register (cache key)
    _fns: Dict[str, Callable] = field(default_factory=dict)
    _symbols: List[str] = field(default_factory=list)
    _service_times: Dict[str, float] = field(default_factory=dict)

    def register(self, name: str, fn: Callable, *,
                 service_time_s: float = 0.0) -> "FunctionLibrary":
        """``service_time_s`` is the *modeled* execution time used when
        the function runs under a VirtualClock (simulation); real
        executors measure execution instead and ignore it."""
        if name in self._fns:
            raise ValueError(f"duplicate symbol {name!r}")
        self._fns[name] = fn
        self._service_times[name] = service_time_s
        self._symbols = sorted(self._fns)      # both sides sort symbols
        self.version += 1                      # invalidates entry caches
        return self

    def entry(self, idx: int) -> tuple:
        """(callable, modeled service time) for one symbol index — the
        per-invocation executor lookup as a single call.  Workers cache
        the result keyed by ``version`` (registration re-sorts symbols
        and shifts indices, so the version bump invalidates)."""
        name = self._symbols[idx]
        return self._fns[name], self._service_times.get(name, 0.0)

    def function(self, fn: Callable) -> Callable:
        """Decorator form of register()."""
        self.register(fn.__name__, fn)
        return fn

    @property
    def symbols(self) -> List[str]:
        return list(self._symbols)

    def index_of(self, name: str) -> int:
        try:
            return self._symbols.index(name)
        except ValueError:
            raise KeyError(f"no symbol {name!r} in library {self.name!r}")

    def by_index(self, idx: int) -> Callable:
        return self._fns[self._symbols[idx]]

    def service_time_of(self, idx: int) -> float:
        """Modeled execution time of a symbol (virtual-clock runs)."""
        return self._service_times.get(self._symbols[idx], 0.0)

    def __len__(self) -> int:
        return len(self._symbols)
