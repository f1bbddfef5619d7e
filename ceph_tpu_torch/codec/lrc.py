"""LRC — Locally Repairable Codes as layered composition of inner codecs.

The port of `ceph_tpu/codec/lrc.py` (Ceph's `lrc` plugin,
src/erasure-code/lrc/ErasureCodeLrc.{h,cc}): a profile is either a JSON
`layers` array plus a global `mapping` string, or the k/m/l shorthand
expanded by parse_kml (ErasureCodeLrc.cc:290-393).  Each layer holds its
own inner codec (default jerasure reed_sol_van, layers_init :210-247),
built through the port's plugin registry on the LRC codec's own device,
over a subset of the global chunk positions given by its chunks_map ('D'
data, 'c' coding, '_' absent).

Encode runs layers top-down with global<->layer index swaps; decode walks
layers in reverse, each layer repairing the erasures it can cover,
gradually improving `decoded` (decode_chunks); _minimum_to_decode prefers
the smallest covering layer so local repairs read fewer shards — the
locality property that makes LRC worth its extra parity.  Every inner
layer is a matrix codec, so a local repair is one small launch over the
layer's chunk subset.
"""

from __future__ import annotations

import json
import re
from typing import Mapping

import numpy as np

import torch

from ..common.errs import EINVAL, EIO
from .base import ErasureCode
from .interface import EcError, ErasureCodeInterface, Profile

# Ceph's dedicated error codes (ErasureCodeLrc.h:25-45) map to
# EINVAL at this surface; messages carry the distinction.
DEFAULT_KML = "-1"


class Layer:
    """One coding layer (ErasureCodeLrc.h:51-61)."""

    def __init__(self, chunks_map: str, profile: Profile):
        self.chunks_map = chunks_map
        self.profile = profile
        self.data = [i for i, c in enumerate(chunks_map) if c == "D"]
        self.coding = [i for i, c in enumerate(chunks_map) if c == "c"]
        self.chunks = self.data + self.coding
        self.chunks_as_set = set(self.chunks)
        self.erasure_code: ErasureCodeInterface | None = None


def _parse_layer_profile(spec) -> Profile:
    """Second layer element: "", "k=v k=v", or a JSON object."""
    if isinstance(spec, dict):
        return {str(k): str(v) for k, v in spec.items()}
    spec = spec.strip()
    if not spec:
        return {}
    if spec.startswith("{"):
        return {str(k): str(v) for k, v in json.loads(spec).items()}
    out: Profile = {}
    for token in spec.split():
        if "=" not in token:
            raise EcError(EINVAL, f"layer profile token {token!r} is not k=v")
        key, val = token.split("=", 1)
        out[key] = val
    return out


def _lenient_json(text: str):
    """json_spirit accepts trailing commas (the kml generator emits them)."""
    cleaned = re.sub(r",(\s*[\]}])", r"\1", text)
    try:
        return json.loads(cleaned)
    except json.JSONDecodeError as e:
        raise EcError(EINVAL, f"could not parse layers JSON: {e}") from e


class ErasureCodeLrc(ErasureCode):
    """Layered locally-repairable code."""

    def __init__(self, device: str | torch.device | None = None) -> None:
        super().__init__(device)
        self.layers: list[Layer] = []
        self._chunk_count = 0
        self._data_chunk_count = 0

    # -- profile parsing ----------------------------------------------------

    def parse_kml(self, profile: Profile) -> None:
        """Expand k/m/l shorthand into mapping + layers
        (ErasureCodeLrc.cc:290-393)."""
        k = self.to_int("k", profile, DEFAULT_KML)
        m = self.to_int("m", profile, DEFAULT_KML)
        lr = self.to_int("l", profile, DEFAULT_KML)
        if k == -1 and m == -1 and lr == -1:
            return
        if -1 in (k, m, lr):
            raise EcError(EINVAL, "all of k, m, l must be set or none of them")
        for generated in ("mapping", "layers", "crush-steps"):
            if generated in profile:
                raise EcError(
                    EINVAL, f"the {generated} parameter cannot be set with k/m/l"
                )
        if lr == 0 or (k + m) % lr:
            raise EcError(EINVAL, "k + m must be a multiple of l")
        groups = (k + m) // lr
        if k % groups:
            raise EcError(EINVAL, "k must be a multiple of (k + m) / l")
        if m % groups:
            raise EcError(EINVAL, "m must be a multiple of (k + m) / l")
        kg, mg = k // groups, m // groups
        profile["mapping"] = ("D" * kg + "_" * mg + "_") * groups
        layers = "[ "
        layers += ' [ "' + ("D" * kg + "c" * mg + "_") * groups + '", "" ],'
        for i in range(groups):
            layers += ' [ "'
            for j in range(groups):
                layers += ("D" * lr + "c") if i == j else ("_" * (lr + 1))
            layers += '", "" ],'
        profile["layers"] = layers + "]"

    def _layers_parse(self, description_string: str) -> None:
        description = _lenient_json(description_string)
        if not isinstance(description, list):
            raise EcError(EINVAL, "layers must be a JSON array")
        for position, entry in enumerate(description):
            if not isinstance(entry, list):
                raise EcError(
                    EINVAL, f"layers[{position}] must be a JSON array, got {entry!r}"
                )
            if not entry or not isinstance(entry[0], str):
                raise EcError(
                    EINVAL, f"layers[{position}][0] must be the chunks_map string"
                )
            layer_profile = _parse_layer_profile(entry[1]) if len(entry) > 1 else {}
            self.layers.append(Layer(entry[0], layer_profile))

    def _layers_init(self) -> None:
        """Instantiate inner codecs (ErasureCodeLrc.cc:210-247) through the
        port's registry, on this codec's device."""
        from . import registry as registry_mod

        registry = registry_mod.instance()
        for layer in self.layers:
            prof = layer.profile
            prof.setdefault("k", str(len(layer.data)))
            prof.setdefault("m", str(len(layer.coding)))
            prof.setdefault("plugin", "jerasure")
            prof.setdefault("technique", "reed_sol_van")
            plugin = prof["plugin"]
            layer.erasure_code = registry.factory(plugin, prof, device=self.device)

    def _layers_sanity_checks(self) -> None:
        if len(self.layers) < 1:
            raise EcError(EINVAL, "layers parameter needs at least one layer")
        for position, layer in enumerate(self.layers):
            if len(layer.chunks_map) != self._chunk_count:
                raise EcError(
                    EINVAL,
                    f"layers[{position}] map {layer.chunks_map!r} must be "
                    f"{self._chunk_count} characters long",
                )

    def init(self, profile: Profile) -> None:
        self.parse_kml(profile)
        self.parse(profile)  # base: chunk_mapping from `mapping`
        if "layers" not in profile:
            raise EcError(EINVAL, "could not find 'layers' in profile")
        description_string = profile["layers"]
        self._layers_parse(description_string)
        self._layers_init()
        if "mapping" not in profile:
            raise EcError(EINVAL, "the 'mapping' profile is missing")
        mapping = profile["mapping"]
        self._data_chunk_count = mapping.count("D")
        self._chunk_count = len(mapping)
        self._layers_sanity_checks()
        # kml-generated parameters are not exposed (ErasureCodeLrc.cc:539-543).
        if profile.get("l", DEFAULT_KML) != DEFAULT_KML:
            profile.pop("mapping", None)
            profile.pop("layers", None)
        self._profile = dict(profile)

    # -- geometry -----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self._chunk_count

    def get_data_chunk_count(self) -> int:
        return self._data_chunk_count

    def get_chunk_size(self, object_size: int) -> int:
        """Delegates to the first (global) layer (ErasureCodeLrc.cc)."""
        return self.layers[0].erasure_code.get_chunk_size(object_size)

    # -- minimum_to_decode (locality-aware; ErasureCodeLrc.cc cases 1-3) ----

    def _minimum_to_decode(self, want_to_read: set[int], available: set[int]) -> set[int]:
        erasures_total = {
            i for i in range(self.get_chunk_count()) if i not in available
        }
        erasures_not_recovered = set(erasures_total)
        erasures_want = erasures_total & want_to_read

        # Case 1: nothing wanted is missing.
        if not erasures_want:
            return set(want_to_read)

        # Case 2: walk layers from most local (last) to global, taking the
        # smallest layer that can repair each wanted erasure.
        minimum: set[int] = set()
        for layer in reversed(self.layers):
            layer_want = want_to_read & layer.chunks_as_set
            if not layer_want:
                continue
            layer_erasures_want = layer_want & erasures_want
            if not layer_erasures_want:
                minimum |= layer_want
                continue
            erasures = layer.chunks_as_set & erasures_not_recovered
            if len(erasures) > layer.erasure_code.get_coding_chunk_count():
                continue  # too many for this layer; hope an upper layer helps
            minimum |= layer.chunks_as_set - erasures_not_recovered
            erasures_not_recovered -= erasures
            erasures_want -= erasures
        if not erasures_want:
            minimum |= want_to_read
            minimum -= erasures_total
            return minimum

        # Case 3: repair everything repairable anywhere; if that clears all
        # erasures, read all available chunks.
        erasures_total = {
            i for i in range(self.get_chunk_count()) if i not in available
        }
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures_total
            if not layer_erasures:
                continue
            if len(layer_erasures) <= layer.erasure_code.get_coding_chunk_count():
                erasures_total -= layer_erasures
        if not erasures_total:
            return set(available)

        raise EcError(EIO, f"not enough chunks in {available} to read {want_to_read}")

    # -- encode / decode ----------------------------------------------------

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        """Apply layers top-down with global<->layer index swap."""
        want = set(chunks)
        top = len(self.layers)
        for idx in range(len(self.layers) - 1, -1, -1):
            top = idx
            if want <= self.layers[idx].chunks_as_set:
                break
        for layer in self.layers[top:]:
            layer_chunks = {j: chunks[c] for j, c in enumerate(layer.chunks)}
            layer.erasure_code.encode_chunks(layer_chunks)
            for j, c in enumerate(layer.chunks):
                chunks[c] = layer_chunks[j]

    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        """Reverse-layer repair, gradually improving `decoded`.

        Ceph makes a single reverse pass (ErasureCodeLrc.cc decode_chunks),
        which misses cascades where a global repair unlocks a later local
        repair (e.g. kml(4,2,3) losing a data chunk and its own local
        parity).  Its _minimum_to_decode case 3 nevertheless promises such
        cascades, so passes repeat until the wanted chunks are recovered or
        a pass makes no progress, as in the JAX package — a strict superset
        of Ceph's recoverability.
        """
        erasures = {i for i in range(self.get_chunk_count()) if i not in chunks}
        want_to_read_erasures = erasures & want_to_read
        progress = True
        while want_to_read_erasures and progress:
            progress = False
            for layer in reversed(self.layers):
                layer_erasures = layer.chunks_as_set & erasures
                if not layer_erasures:
                    continue
                if len(layer_erasures) > layer.erasure_code.get_coding_chunk_count():
                    continue  # too many for this layer
                layer_want: set[int] = set()
                layer_chunks: dict[int, np.ndarray] = {}
                layer_decoded: dict[int, np.ndarray] = {}
                for j, c in enumerate(layer.chunks):
                    # Pick from `decoded` (not `chunks`) to reuse chunks
                    # repaired by previous layers/passes.
                    if c not in erasures:
                        layer_chunks[j] = decoded[c]
                    if c in want_to_read:
                        layer_want.add(j)
                    layer_decoded[j] = decoded[c]
                layer.erasure_code.decode_chunks(
                    layer_want, layer_chunks, layer_decoded
                )
                for j, c in enumerate(layer.chunks):
                    decoded[c] = layer_decoded[j]
                    erasures.discard(c)
                progress = True
                want_to_read_erasures = erasures & want_to_read
                if not want_to_read_erasures:
                    break
        if want_to_read_erasures:
            raise EcError(
                EIO, f"unable to read {want_to_read_erasures} of {want_to_read}"
            )
