"""Plugin registry — mirror of `ErasureCodePluginRegistry`.

The port's own copy of `ceph_tpu/codec/registry.py` (Ceph
src/erasure-code/ErasureCodePlugin.{h,cc}).  Ceph dlopens `libec_<name>.so`,
checks `__erasure_code_version()` against the build version (mismatch ->
-EXDEV, :134-143), calls `__erasure_code_init(name, dir)` which registers a
Plugin whose `factory()` builds codec instances, and verifies the instance's
profile round-trips (:86-114).

Here plugins are Python modules under `ceph_tpu_torch.codec.plugins`, loaded
on demand, so the port's plugin keeps the name `tpu`.  The factory takes
the codec's device as a keyword, never as a profile key: the profile must
round-trip unchanged.
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable

import torch

from ..common.errs import EEXIST, ENOENT, EXDEV
from .interface import EcError, ErasureCodeInterface, Profile

# The ABI version plugins must declare (reference: CEPH_GIT_NICE_VER check).
EC_VERSION = "ceph_tpu-1"

PLUGIN_PACKAGE = "ceph_tpu_torch.codec.plugins"

Device = str | torch.device | None


class ErasureCodePlugin:
    """A registered factory (ErasureCodePlugin.h:39)."""

    def __init__(
        self, name: str, factory: Callable[[Profile, Device], ErasureCodeInterface]
    ):
        self.name = name
        self._factory = factory

    def factory(self, profile: Profile, device: Device = None) -> ErasureCodeInterface:
        return self._factory(profile, device)


class ErasureCodePluginRegistry:
    """Singleton get-or-load registry (ErasureCodePlugin.h:45)."""

    _instance: "ErasureCodePluginRegistry | None" = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._plugins: dict[str, ErasureCodePlugin] = {}

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        """ErasureCodePlugin.cc registry.add: duplicate -> -EEXIST."""
        with self._lock:
            if name in self._plugins:
                raise EcError(EEXIST, f"plugin {name} already registered")
            self._plugins[name] = plugin

    def load(self, name: str) -> ErasureCodePlugin:
        """Import-and-register, with the reference's failure-mode contract:
        missing entry point / bad version map to the same errnos the dlopen
        path produces (ErasureCodePlugin.cc:126-163)."""
        with self._lock:
            plugin = self._plugins.get(name)
            if plugin is not None:
                return plugin
            try:
                mod = importlib.import_module(f"{PLUGIN_PACKAGE}.{name}")
            except ImportError as e:
                raise EcError(ENOENT, f"plugin {name} not found") from e
            version = getattr(mod, "__erasure_code_version__", None)
            if version is None:
                raise EcError(EXDEV, f"plugin {name} missing __erasure_code_version__")
            if version != EC_VERSION:
                raise EcError(
                    EXDEV, f"plugin {name} version {version} != expected {EC_VERSION}"
                )
            init = getattr(mod, "__erasure_code_init__", None)
            if init is None:
                raise EcError(ENOENT, f"plugin {name} missing __erasure_code_init__")
            init(self)
            plugin = self._plugins.get(name)
            if plugin is None:
                raise EcError(EXDEV, f"plugin {name} init did not register itself")
            return plugin

    def factory(
        self, name: str, profile: Profile, *, device: Device = None
    ) -> ErasureCodeInterface:
        """Get-or-load + instantiate on `device` + profile round-trip check
        (ErasureCodePlugin.cc:86-114)."""
        plugin = self.load(name)
        ec = plugin.factory(profile, device)
        got = ec.get_profile()
        if got != profile:
            raise EcError(
                EXDEV,
                f"profile {profile} != get_profile() {got} for plugin {name}",
            )
        return ec

    def preload(self, plugins_list: str) -> None:
        """Load a comma- or space-separated plugin list at startup
        (ErasureCodePlugin.cc:180-196)."""
        for name in plugins_list.replace(",", " ").split():
            if name:
                self.load(name)


def instance() -> ErasureCodePluginRegistry:
    return ErasureCodePluginRegistry.instance()
