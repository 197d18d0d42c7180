"""Configuration store + image registry (paper Fig. 1, right side).

The port's own copy of the JAX package's ``core/config_store.py``, which holds
no JAX: the port imports nothing of that package.

The paper assumes "the cloud platform already offers ... a key-value store for
the configuration that can scale with the demands of the platform" — so these
are deliberately thin KV interfaces (swap in etcd/Spanner/whatever in prod).
Workers read them to start instances; smarter load balancers may read them too.
"""
from __future__ import annotations

import json
import threading
from typing import Callable, Dict

from repro_torch.core.types import FunctionConfig


class ConfigStore:
    """Versioned KV store of FunctionConfigs (thread-safe, watchable)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, FunctionConfig] = {}
        self._version: Dict[str, int] = {}
        self._watchers = []

    def put(self, cfg: FunctionConfig):
        with self._lock:
            self._data[cfg.name] = cfg
            self._version[cfg.name] = self._version.get(cfg.name, 0) + 1
            watchers = list(self._watchers)
        for w in watchers:
            w(cfg)

    def get(self, name: str) -> FunctionConfig:
        with self._lock:
            if name not in self._data:
                raise KeyError(f"function {name!r} not registered")
            return self._data[name]

    def version(self, name: str) -> int:
        with self._lock:
            return self._version.get(name, 0)

    def list(self):
        with self._lock:
            return sorted(self._data)

    def watch(self, fn: Callable[[FunctionConfig], None]):
        self._watchers.append(fn)

    def dump_json(self) -> str:
        with self._lock:
            return json.dumps({k: vars(v) for k, v in self._data.items()},
                              sort_keys=True, default=str)


class ImageRegistry:
    """Function "images": factories that materialize an executable instance.

    In HyperFaaS an image is a Docker container; here it is a factory that
    returns a model (weight materialization + warm-up = the cold start).
    """

    def __init__(self):
        self._factories: Dict[str, Callable] = {}

    def register(self, arch: str, factory: Callable):
        self._factories[arch] = factory

    def pull(self, arch: str) -> Callable:
        if arch not in self._factories:
            raise KeyError(f"image {arch!r} not in registry")
        return self._factories[arch]

    def list(self):
        return sorted(self._factories)
