"""CLAY — Coupled-LAYer MSR regenerating codes.

The port of `ceph_tpu/codec/clay.py` (Ceph's `clay` plugin,
src/erasure-code/clay/ErasureCodeClay.{h,cc}): a (k, m, d) MSR code that
repairs one lost chunk reading only d helpers x 1/q of each chunk
(q = d-k+1).  Nodes live on a (q, t) grid (t = (k+m+nu)/q, nu pads k+m to a
multiple of q); each chunk is q^t sub-chunks ("planes"); coupled chunk
values C relate to uncoupled values U by pairwise 2x2 GF transforms across
the grid, and each plane of U is a codeword of an inner scalar MDS code
(ErasureCodeClay.cc:271-296 for the geometry; :645-739 for layered
decoding; :462-642 for single-chunk repair).

As in the JAX package, chunks live as one (q*t, q^t, sc) array; the
pairwise coupling transforms (`_compute_U`, `_recover_C`, `_gf_scale`)
stay host numpy, batched over planes with table lookups, and each score
round of layered decoding runs the inner MDS decode for all planes of
that score in ONE launch of the inner code's `PLAN_CACHE.decode_coder` on
the codec's device (planes, and in `decode_fragments_batch` stripes, are
batch axes).  The coder's tier follows the sub-chunk length: at k = 8,
m = 4, d = 11 (64 sub-chunks) a 4 KiB chunk has 64-byte sub-chunks, which
take the bitsliced matmul or the packed program, not SWAR.

Profile: k, m, d (default k+m-1), scalar_mds in {jerasure, isa, tpu}
(default jerasure), technique per inner plugin; the inner codecs come from
the port's registry on this codec's device.  scalar_mds=shec is rejected
(EINVAL), as in the JAX package: SHEC's decode has no decode matrix.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..common.errs import EINVAL, EIO
from ..gf import GF_MUL_TABLE, gf_inv, gf_invert_matrix
from .base import ErasureCode
from .interface import EcError, Profile
from .matrix_codec import PLAN_CACHE


def _gf_scale(c: int, arr: np.ndarray) -> np.ndarray:
    """Multiply a uint8 array by the GF(2^8) scalar c (table lookup)."""
    return GF_MUL_TABLE[c][arr]


class ErasureCodeClay(ErasureCode):
    DEFAULT_K = "4"
    DEFAULT_M = "2"

    def __init__(self, device: str | torch.device | None = None) -> None:
        super().__init__(device)
        self.k = 0
        self.m = 0
        self.d = 0
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 0
        self._inner = None  # inner scalar MDS codec over (k+nu, m)
        self._pft = None  # 2x2 parity matrix of the pairwise transform

    # -- init ---------------------------------------------------------------

    def parse(self, profile: Profile) -> None:
        super().parse(profile)
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.sanity_check_k_m(self.k, self.m)
        self.d = self.to_int("d", profile, str(self.k + self.m - 1))
        if not (self.k <= self.d <= self.k + self.m - 1):
            raise EcError(
                EINVAL, f"d={self.d} must be within [{self.k}, {self.k + self.m - 1}]"
            )
        scalar_mds = profile.get("scalar_mds") or "jerasure"
        if scalar_mds == "shec":
            raise EcError(
                EINVAL,
                "scalar_mds=shec is not supported by the clay codec "
                "(SHEC's decode is not matrix-planned); use jerasure/isa/tpu",
            )
        if scalar_mds not in ("jerasure", "isa", "tpu"):
            raise EcError(EINVAL, f"scalar_mds={scalar_mds} not supported")
        self.scalar_mds = scalar_mds
        technique = profile.get("technique") or "reed_sol_van"
        self.technique = technique

        self.q = self.d - self.k + 1
        self.nu = (self.q - (self.k + self.m) % self.q) % self.q
        if self.k + self.m + self.nu > 254:
            raise EcError(EINVAL, "k+m+nu must be <= 254")
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t

        # Inner MDS codec over (k+nu) data chunks; same plugin family as
        # Ceph wires up (ErasureCodeClay.cc:283-293), on this device.
        from . import registry as registry_mod

        registry = registry_mod.instance()
        inner_profile = {
            "k": str(self.k + self.nu),
            "m": str(self.m),
            "technique": technique,
        }
        plugin = "tpu" if scalar_mds == "isa" else scalar_mds
        if plugin == "jerasure":
            inner_profile["w"] = "8"
        self._inner = registry.factory(plugin, inner_profile, device=self.device)
        # Pairwise transform = parity rows of the same family's (2, 2) code
        # (Ceph's `pft` instance, ErasureCodeClay.cc:291-293).
        pft_codec = registry.factory(
            plugin,
            {"k": "2", "m": "2", "technique": technique,
             **({"w": "8"} if plugin == "jerasure" else {})},
            device=self.device,
        )
        self._pft = pft_codec.distribution_matrix()[2:]  # (2, 2)
        self._pft_inv = gf_invert_matrix(self._pft)
        assert self._pft_inv is not None
        assert (self._pft != 0).all(), "pairwise transform needs nonzero entries"
        self._plane_digits = self._compute_plane_digits()

    def init(self, profile: Profile) -> None:
        self.parse(profile)
        self._profile = dict(profile)

    def _compute_plane_digits(self) -> np.ndarray:
        """(sub_chunk_no, t) base-q digits; digit y = (z // q^(t-1-y)) % q."""
        z = np.arange(self.sub_chunk_no)
        digits = np.empty((self.sub_chunk_no, self.t), dtype=np.int64)
        for y in range(self.t):
            digits[:, y] = (z // self.q ** (self.t - 1 - y)) % self.q
        return digits

    # -- geometry -----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, object_size: int) -> int:
        """round_up(object, sub_chunk_no * k * inner_alignment) / k
        (ErasureCodeClay.cc:90-96)."""
        alignment = self.sub_chunk_no * self.k * self._inner.get_chunk_size(1)
        padded = -(-object_size // alignment) * alignment
        return padded // self.k

    # -- node/plane helpers --------------------------------------------------

    def _ext(self, i: int) -> int:
        """External chunk id -> grid node id (parities shift by nu)."""
        return i if i < self.k else i + self.nu

    def _partner(self, node: int, z: int) -> tuple[int, int]:
        """Coupled partner of grid node `node` at plane z: (node_sw, z_sw)."""
        x, y = node % self.q, node // self.q
        zy = int(self._plane_digits[z, y])
        node_sw = y * self.q + zy
        z_sw = z + (x - zy) * self.q ** (self.t - 1 - y)
        return node_sw, z_sw

    def _code(self, coder, survivors: np.ndarray) -> np.ndarray:
        """One inner-MDS launch: (..., k+nu, sc) host survivors through the
        decode coder on the codec's device -> (..., nerrs, sc) host bytes."""
        dev = torch.from_numpy(np.ascontiguousarray(survivors)).to(self.device)
        return coder(dev).cpu().numpy()

    # -- coupling transforms (batched over planes) ---------------------------

    def _compute_U(self, node: int, planes: np.ndarray, C: np.ndarray,
                   U: np.ndarray) -> None:
        """Fill U[node, planes] from coupled values.

        Canonical pair order: position A = larger-x node, B = smaller-x; the
        transform is [U_A; U_B] = P @ [C_A; C_B] with P the (2,2) parity
        matrix (Ceph reaches the same values through pft decode_chunks
        with erasures {2,3}, ErasureCodeClay.cc:839-869).
        Vectorized: planes is an int array; dots copy, pairs gather both C
        sides and apply the 2x2 GF map via table lookups.
        """
        x, y = node % self.q, node // self.q
        zy = self._plane_digits[planes, y]
        dots = planes[zy == x]
        if dots.size:
            U[node, dots] = C[node, dots]
        others = planes[zy != x]
        if others.size == 0:
            return
        zy_o = self._plane_digits[others, y]
        node_sw = y * self.q + zy_o
        z_sw = others + (x - zy_o) * self.q ** (self.t - 1 - y)
        c_self = C[node, others]
        c_partner = C[node_sw, z_sw]
        P = self._pft
        is_a = x > zy_o  # node is the larger-x (position A) member
        # U_A = P00 C_A + P01 C_B ; U_B = P10 C_A + P11 C_B
        out = np.where(
            is_a[:, None],
            _gf_scale(int(P[0, 0]), c_self) ^ _gf_scale(int(P[0, 1]), c_partner),
            _gf_scale(int(P[1, 1]), c_self) ^ _gf_scale(int(P[1, 0]), c_partner),
        )
        U[node, others] = out

    def _recover_C(self, node: int, planes: np.ndarray, C: np.ndarray,
                   U: np.ndarray, erased: set[int]) -> None:
        """Fill C[node, planes] for an erased node after U is known.

        Three cases per plane (ErasureCodeClay.cc:684-706): dot -> copy;
        partner alive -> solve the pair equation for this node's C; both
        erased -> invert the full 2x2 (done once per pair, from the larger-x
        side, writing both nodes like get_coupled_from_uncoupled).
        """
        x, y = node % self.q, node // self.q
        zy = self._plane_digits[planes, y]
        dots = planes[zy == x]
        if dots.size:
            C[node, dots] = U[node, dots]
        others = planes[zy != x]
        if others.size == 0:
            return
        zy_o = self._plane_digits[others, y]
        node_sw_arr = y * self.q + zy_o
        z_sw_arr = others + (x - zy_o) * self.q ** (self.t - 1 - y)
        P, Pinv = self._pft, self._pft_inv
        for partner in np.unique(node_sw_arr):
            sel = node_sw_arr == partner
            zs, zsw = others[sel], z_sw_arr[sel]
            if int(partner) not in erased:
                # type-1: partner C known.  If node is A:
                # C_A = P00^-1 (U_A ^ P01 C_B); symmetric for B.
                if x > int(partner) % self.q:
                    inv = gf_inv(int(P[0, 0]))
                    C[node, zs] = _gf_scale(
                        inv, U[node, zs] ^ _gf_scale(int(P[0, 1]), C[partner, zsw])
                    )
                else:
                    inv = gf_inv(int(P[1, 1]))
                    C[node, zs] = _gf_scale(
                        inv, U[node, zs] ^ _gf_scale(int(P[1, 0]), C[partner, zsw])
                    )
            elif x > int(partner) % self.q:
                # both erased: [C_A; C_B] = P^-1 [U_A; U_B]; write both sides
                # once from the A side (Ceph guards with z_vec[y] < x).
                ua, ub = U[node, zs], U[partner, zsw]
                C[node, zs] = _gf_scale(int(Pinv[0, 0]), ua) ^ _gf_scale(
                    int(Pinv[0, 1]), ub
                )
                C[partner, zsw] = _gf_scale(int(Pinv[1, 0]), ua) ^ _gf_scale(
                    int(Pinv[1, 1]), ub
                )

    # -- layered decode (ErasureCodeClay.cc:645-710) -------------------------

    def _decode_layered(self, erased: set[int], C: np.ndarray) -> None:
        """Recover C[e] for all erased grid nodes in-place.

        C has shape (q*t, sub_chunk_no, sc).  Erasures are padded to exactly
        m with virtual (shortening) nodes.  Rounds are ordered by
        intersection score; within a round everything is batched.
        """
        qt = self.q * self.t
        num = len(erased)
        assert num > 0
        erased = set(erased)
        for i in range(self.k + self.nu, qt):
            if len(erased) >= self.m:
                break
            erased.add(i)
        assert len(erased) == self.m, (erased, self.m)

        # order[z] = number of erased nodes sitting on their own dot.
        order = np.zeros(self.sub_chunk_no, dtype=np.int64)
        for e in erased:
            order += self._plane_digits[:, e // self.q] == e % self.q

        U = np.zeros_like(C)
        erased_sorted = sorted(erased)
        dist = self._inner.distribution_matrix()
        coder, decode_index = PLAN_CACHE.decode_coder(
            dist, erased_sorted, self.k + self.nu, self.device
        )
        alive = [i for i in range(qt) if i not in erased]
        for score in range(int(order.max()) + 1):
            planes = np.nonzero(order == score)[0]
            if planes.size == 0:
                continue
            # 1. uncouple all alive nodes on these planes
            for node in alive:
                self._compute_U(node, planes, C, U)
            # 2. inner MDS decode of erased U's — one batched device launch
            #    over (|planes|, k+nu, sc)
            survivors = U[decode_index][:, planes]  # (k+nu, P, sc)
            rec = self._code(coder, survivors.transpose(1, 0, 2))  # (P, nerr, sc)
            for p, e in enumerate(erased_sorted):
                U[e, planes] = rec[:, p]
            # 3. re-couple erased nodes on these planes
            for e in erased_sorted:
                self._recover_C(e, planes, C, U, erased)

    # -- chunk-level interface ----------------------------------------------

    def _grid_arrays(self, chunks: Mapping[int, np.ndarray], chunk_size: int):
        """(q*t, sub_chunk_no, sc) coupled tensor from external chunk dict;
        virtual shortening nodes are zero."""
        qt = self.q * self.t
        sc = chunk_size // self.sub_chunk_no
        C = np.zeros((qt, self.sub_chunk_no, sc), dtype=np.uint8)
        for i, buf in chunks.items():
            C[self._ext(i)] = np.asarray(buf, dtype=np.uint8).reshape(
                self.sub_chunk_no, sc
            )
        return C

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        chunk_size = len(chunks[0])
        if chunk_size % self.sub_chunk_no:
            raise EcError(EINVAL, f"chunk size {chunk_size} not divisible by "
                                  f"sub_chunk_no {self.sub_chunk_no}")
        C = self._grid_arrays({i: chunks[i] for i in range(self.k)}, chunk_size)
        parity_nodes = {self._ext(i) for i in range(self.k, self.k + self.m)}
        self._decode_layered(parity_nodes, C)
        for i in range(self.k, self.k + self.m):
            np.copyto(chunks[i], C[self._ext(i)].reshape(-1))

    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        erasures_ext = [i for i in range(self.k + self.m) if i not in chunks]
        if not erasures_ext:
            return
        if len(erasures_ext) > self.m:
            raise EcError(EIO, f"{len(erasures_ext)} erasures > m={self.m}")
        chunk_size = len(next(iter(chunks.values())))
        C = self._grid_arrays(chunks, chunk_size)
        erased_nodes = {self._ext(i) for i in erasures_ext}
        self._decode_layered(erased_nodes, C)
        for i in erasures_ext:
            np.copyto(decoded[i], C[self._ext(i)].reshape(-1))

    # -- repair path (sub-chunk reads; ErasureCodeClay.cc:304-460) -----------

    def is_repair(self, want_to_read: set[int], available: set[int]) -> bool:
        if want_to_read <= available:
            return False
        if len(want_to_read) > 1:
            return False
        lost = self._ext(next(iter(want_to_read)))
        y = lost // self.q
        for x in range(self.q):
            node = y * self.q + x
            ext = node if node < self.k else node - self.nu
            if node == lost:
                continue
            if self.k <= node < self.k + self.nu:
                continue  # virtual shortening node is always "available"
            if ext not in available:
                return False
        return len(available) >= self.d

    def get_repair_subchunks(self, lost_node: int) -> list[tuple[int, int]]:
        """(offset, count) runs of sub-chunks read from each helper
        (ErasureCodeClay.cc:363-377)."""
        y, x = lost_node // self.q, lost_node % self.q
        seq = self.q ** (self.t - 1 - y)
        runs = []
        index = x * seq
        for _ in range(self.q ** y):
            runs.append((index, seq))
            index += self.q * seq
        return runs

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> dict[int, list[tuple[int, int]]]:
        if not self.is_repair(want_to_read, available):
            return super().minimum_to_decode(want_to_read, available)
        lost_ext = next(iter(want_to_read))
        lost = self._ext(lost_ext)
        runs = self.get_repair_subchunks(lost)
        minimum: dict[int, list[tuple[int, int]]] = {}
        y = lost // self.q
        for x in range(self.q):
            node = y * self.q + x
            if node == lost:
                continue
            if node < self.k:
                minimum[node] = list(runs)
            elif node >= self.k + self.nu:
                minimum[node - self.nu] = list(runs)
        for chunk in sorted(available):
            if len(minimum) >= self.d:
                break
            minimum.setdefault(chunk, list(runs))
        assert len(minimum) == self.d
        return minimum

    def decode(
        self,
        want_to_read: set[int],
        chunks: Mapping[int, np.ndarray],
        chunk_size: int = 0,
    ) -> dict[int, np.ndarray]:
        avail = set(chunks)
        if (
            chunk_size
            and self.is_repair(want_to_read, avail)
            and chunk_size > len(next(iter(chunks.values())))
        ):
            return self._repair(want_to_read, chunks, chunk_size)
        return super().decode(want_to_read, chunks, chunk_size)

    def decode_fragments_batch(
        self,
        want_to_read: set[int],
        helper_chunks: Mapping[int, np.ndarray],
        chunk_size: int,
    ) -> dict[int, np.ndarray]:
        """Vectorized repair across a whole shard's stripes at once.

        Helper values are (stripes, fragment) uint8 arrays — stripe s's
        repair-plane fragment in row s — and the result maps the lost
        chunk to a (stripes, chunk_size) array.  Each score round runs
        ONE inner-MDS launch over (planes, stripes, k+nu, sc) instead of
        a per-stripe loop: stripes are just another batch axis."""
        if not self.is_repair(want_to_read, set(helper_chunks)):
            raise EcError(EIO, "fragment decode requires a repair-plan read")
        return self._repair(want_to_read, helper_chunks, chunk_size)

    def _repair(
        self,
        want_to_read: set[int],
        helper_chunks: Mapping[int, np.ndarray],
        chunk_size: int,
    ) -> dict[int, np.ndarray]:
        """Single-chunk repair from d helpers' sub-chunk fragments.

        Helpers supply only the repair planes (sub_chunk_no / q of each
        chunk); the lost chunk is rebuilt in full.  Mirrors
        repair_one_lost_chunk (ErasureCodeClay.cc:462-642) with batched
        plane groups: repair planes are processed in intersection-score
        rounds; each round uncouples helpers, runs one batched inner-MDS
        decode, and re-couples — recovering q lost sub-chunks per repair
        plane (the dot plus q-1 shifted partners).

        Helper buffers may be flat (one fragment) or (stripes, fragment)
        2-D (decode_fragments_batch): every transform below is
        elementwise over the trailing axes and the inner-MDS coder takes
        arbitrary leading batch dims, so the stripe axis rides along.
        """
        assert len(want_to_read) == 1 and len(helper_chunks) == self.d
        lost_ext = next(iter(want_to_read))
        lost = self._ext(lost_ext)
        qt = self.q * self.t
        sc = chunk_size // self.sub_chunk_no
        repair_planes = np.array(
            sorted(
                z
                for run in self.get_repair_subchunks(lost)
                for z in range(run[0], run[0] + run[1])
            )
        )
        n_rep = repair_planes.size
        plane_pos = {int(z): i for i, z in enumerate(repair_planes)}
        repair_blocksize = n_rep * sc

        # Scatter helper fragments into full-size C/U arrays (only repair
        # planes are populated); aloof = alive nodes that sent nothing.
        first = np.asarray(next(iter(helper_chunks.values())), dtype=np.uint8)
        lead = first.shape[:-1] if first.ndim == 2 else ()
        C = np.zeros((qt, self.sub_chunk_no, *lead, sc), dtype=np.uint8)
        helpers: set[int] = set()
        for i, buf in helper_chunks.items():
            buf = np.asarray(buf, dtype=np.uint8)
            node = self._ext(i)
            if lead:
                assert buf.shape == (*lead, repair_blocksize), (
                    buf.shape, lead, repair_blocksize,
                )
                # (S, n_rep, sc) -> plane-major (n_rep, S, sc) for the
                # C[node, planes] scatter
                C[node, repair_planes] = buf.reshape(
                    *lead, n_rep, sc
                ).transpose(1, 0, 2)
            else:
                assert buf.size == repair_blocksize, (buf.size, repair_blocksize)
                C[node, repair_planes] = buf.reshape(n_rep, sc)
            helpers.add(node)
        helpers |= set(range(self.k, self.k + self.nu))  # shortening zeros
        aloof = {
            n
            for n in range(qt)
            if n not in helpers and n != lost
        }
        y_lost = lost // self.q
        erased = {y_lost * self.q + x for x in range(self.q)} | aloof
        if len(erased) > self.m:
            raise EcError(EIO, f"repair erasure set {erased} exceeds m={self.m}")

        order = np.zeros(self.sub_chunk_no, dtype=np.int64)
        for e in ({lost} | aloof):
            order += self._plane_digits[:, e // self.q] == e % self.q
        U = np.zeros_like(C)
        erased_sorted = sorted(erased)
        dist = self._inner.distribution_matrix()
        coder, decode_index = PLAN_CACHE.decode_coder(
            dist, erased_sorted, self.k + self.nu, self.device
        )
        out = np.zeros((self.sub_chunk_no, *lead, sc), dtype=np.uint8)
        P, Pinv = self._pft, self._pft_inv
        max_order = int(order[repair_planes].max())
        min_order = int(order[repair_planes].min())
        for score in range(min_order, max_order + 1):
            planes = repair_planes[order[repair_planes] == score]
            if planes.size == 0:
                continue
            # 1. uncouple non-erased nodes on these planes (lost-row helpers
            # are in `erased`: their U comes from the MDS decode, like
            # Ceph's erasure guard at ErasureCodeClay.cc:540).  A
            # node's partner is either a helper (z_sw also a repair plane),
            # an aloof node (use its U from an earlier round), or the dot.
            for node in sorted(helpers - erased):
                x, y = node % self.q, node // self.q
                zy = self._plane_digits[planes, y]
                dots = planes[zy == x]
                if dots.size:
                    U[node, dots] = C[node, dots]
                others = planes[zy != x]
                if others.size == 0:
                    continue
                zy_o = self._plane_digits[others, y]
                partner_arr = y * self.q + zy_o
                z_sw_arr = others + (x - zy_o) * self.q ** (self.t - 1 - y)
                for partner in np.unique(partner_arr):
                    selm = partner_arr == partner
                    zs, zsw = others[selm], z_sw_arr[selm]
                    is_a = x > int(partner) % self.q
                    if int(partner) in aloof:
                        # know C_self and U_partner (earlier round):
                        # solve pair for U_self.
                        cs = C[node, zs]
                        up = U[partner, zsw]
                        if is_a:
                            # C_B = P11^-1 (U_B ^ P10 C_A); U_A = P00 C_A ^ P01 C_B
                            cb = _gf_scale(
                                gf_inv(int(P[1, 1])),
                                up ^ _gf_scale(int(P[1, 0]), cs),
                            )
                            U[node, zs] = _gf_scale(int(P[0, 0]), cs) ^ _gf_scale(
                                int(P[0, 1]), cb
                            )
                        else:
                            ca = _gf_scale(
                                gf_inv(int(P[0, 0])),
                                up ^ _gf_scale(int(P[0, 1]), cs),
                            )
                            U[node, zs] = _gf_scale(int(P[1, 1]), cs) ^ _gf_scale(
                                int(P[1, 0]), ca
                            )
                    else:
                        cs = C[node, zs]
                        cp = C[partner, zsw]
                        if is_a:
                            U[node, zs] = _gf_scale(int(P[0, 0]), cs) ^ _gf_scale(
                                int(P[0, 1]), cp
                            )
                        else:
                            U[node, zs] = _gf_scale(int(P[1, 1]), cs) ^ _gf_scale(
                                int(P[1, 0]), cp
                            )
            # 2. batched inner MDS decode for erased U's: (|planes|[, S],
            # k+nu, sc) — contraction axis at -2, stripes ride as a
            # leading batch dim.
            survivors = U[decode_index][:, planes]
            rec = self._code(coder, np.moveaxis(survivors, 0, -2))
            for p, e in enumerate(erased_sorted):
                U[e, planes] = rec[..., p, :]
            # 3. recover lost C sub-chunks: the dot (plane itself) plus the
            # shifted partners via helpers in the lost row.
            out[planes] = U[lost, planes]  # dot: repair planes have
            # z_vec[y_lost] == x_lost
            for x in range(self.q):
                node = y_lost * self.q + x
                if node == lost or node in aloof:
                    continue
                if node not in helpers:
                    continue
                zy = self._plane_digits[planes, y_lost]
                sel = planes  # all repair planes have dot == lost in y_lost
                z_sw = sel + (x - zy) * self.q ** (self.t - 1 - y_lost)
                # helper (x, y_lost): C known at plane z, U decoded at z;
                # solve pair for C_lost at z_sw.
                cs = C[node, sel]
                us = U[node, sel]
                if x > lost % self.q:
                    # helper is A: U_A = P00 C_A ^ P01 C_B -> C_B
                    cb = _gf_scale(
                        gf_inv(int(P[0, 1])), us ^ _gf_scale(int(P[0, 0]), cs)
                    )
                    out[z_sw] = cb
                else:
                    ca = _gf_scale(
                        gf_inv(int(P[1, 0])), us ^ _gf_scale(int(P[1, 1]), cs)
                    )
                    out[z_sw] = ca
        if lead:
            # plane-major (sub_chunk_no, S, sc) -> per-stripe chunks
            return {lost_ext: out.transpose(1, 0, 2).reshape(*lead, -1)}
        return {lost_ext: out.reshape(-1)}
