"""The benchmark's plain clay reference: the coupled-layer MSR code of
Vajha et al., "Clay Codes: Moulding MDS Codes to Yield an MSR Code"
(USENIX FAST 2018), as Ceph's ``ErasureCodeClay`` builds it over a
jerasure ``reed_sol_van`` scalar code, in plain PyTorch.

- Geometry (``ErasureCodeClay::parse`` / ``prepare``): q = d - k + 1;
  nu virtual data nodes, always zero, pad k + m to a multiple of q;
  t = (k + m + nu) / q; a chunk is q^t sub-chunks, one a plane.  Chunk
  i < k is node i, parity chunk k + j is node k + nu + j, and node n
  sits at (x, y) = (n % q, n // q).
- Vertices: (x, y, z) is a *dot* where digit y of plane z is x;
  otherwise it pairs with (z_y, y, z'), z' being z with digit y set to
  x.  The stored (coupled) values C and the uncoupled values U of a
  pair are tied by the pair transform [C_0; C_1] = P [U_0; U_1], P the
  (2, 2) coding matrix of ``reed_sol_van`` k=2 m=2; a dot has C = U.
- Every plane's U is a codeword of the scalar MDS code: ``reed_sol_van``
  with k + nu data rows and m coding rows (``gf256.reed_sol_van``).
- Encode is the layered decode of the m coding nodes: planes in order
  of their intersection score (how many erased nodes are dots there);
  in each, the known nodes' U (from both C of a pair, or from the own C
  and the pair's U solved in an earlier plane), then the erased nodes'
  U by the scalar code; last, the erased nodes' C from the U of each
  pair.
- Repair of one lost node from d helpers reads the helpers' *repair
  planes*, the q^(t-1) planes where the lost node is a dot, in plane
  order (``minimum_to_decode``'s runs).  Per repair plane, in order of
  the aloof nodes' (the non-helpers') intersection score: the scalar
  code solves the lost node, the aloof nodes and the rest of the lost
  node's column; the lost chunk's other planes follow from its column
  neighbours' C and U in the paired repair plane.

Departures from Ceph's source, the conventions of the program's own
clay, to which this reference is held byte for byte: digit y of a plane
weighs q^y (Ceph's ``get_plane_vector`` gives ``z_vec[y]`` the weight
q^(t-1-y), so it numbers a chunk's sub-chunks in another order), and P
acts on a pair directly with slot 0 the node of smaller x (Ceph runs
the pair transform through a k=2 m=2 jerasure code instance in that
code's chunk order).  Only ``scalar_mds=jerasure technique=reed_sol_van``
is built.

Nothing here imports the program under test.  Products are looked up
in gf256's 256 x 256 table; a value is a (stripes, sub-chunk bytes)
tensor, so Python loops only over planes and nodes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf256


def _mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b over GF(2^8)."""
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.int64)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = 0
            for t in range(a.shape[1]):
                acc ^= gf256.gf_mul(int(a[i, t]), int(b[t, j]))
            out[i, j] = acc
    return out


class Clay:
    """One clay code: k data, m parity chunks, d helpers a repair."""

    def __init__(self, k: int, m: int, d: int) -> None:
        if not k <= d <= k + m - 1:
            raise ValueError(f"d={d} outside [k, k+m-1] for k={k} m={m}")
        self.k, self.m, self.d = k, m, d
        self.q = q = d - k + 1
        self.nu = (q - (k + m) % q) % q
        self.t = (k + m + self.nu) // q
        self.sub = q ** self.t
        self.nodes = k + self.nu + m
        self.kk = k + self.nu
        # the scalar code's generator rows, node by node: identity over
        # the data nodes (virtual ones included), reed_sol_van's below
        self.gen = np.vstack([np.eye(self.kk, dtype=np.int64),
                              gf256.reed_sol_van(self.kk, m)])
        self.pft = gf256.reed_sol_van(2, 2)
        # the 2 x 2 inverse over GF(2^8): the adjugate over the
        # determinant (minus is plus in characteristic 2)
        (a, b), (c, e) = self.pft.tolist()
        inv = gf256.gf_inv(gf256.gf_mul(a, e) ^ gf256.gf_mul(b, c))
        self.pft_inv = np.array([[gf256.gf_mul(inv, v) for v in (e, b)],
                                 [gf256.gf_mul(inv, v) for v in (c, a)]],
                                dtype=np.int64)
        self._tables = {}
        self._rows = {}

    @classmethod
    def from_profile(cls, profile: dict) -> "Clay":
        if profile.get("plugin") != "clay" \
                or profile.get("scalar_mds", "jerasure") != "jerasure" \
                or profile.get("technique", "reed_sol_van") != "reed_sol_van":
            raise ValueError(f"no clay reference for profile {profile}")
        k, m = int(profile["k"]), int(profile["m"])
        return cls(k, m, int(profile.get("d", k + m - 1)))

    # -- the grid --------------------------------------------------------

    def node(self, chunk: int) -> int:
        return chunk if chunk < self.k else chunk + self.nu

    def is_virtual(self, node: int) -> bool:
        return self.k <= node < self.kk

    def digit(self, z: int, y: int) -> int:
        return (z // self.q ** y) % self.q

    def pair(self, node: int, z: int):
        """(node, plane) paired with vertex (node, z); None for a dot."""
        x, y = node % self.q, node // self.q
        xp = self.digit(z, y)
        if xp == x:
            return None
        return y * self.q + xp, z + (x - xp) * self.q ** y

    def _slot(self, node: int, other: int) -> int:
        return 0 if node % self.q < other % self.q else 1

    def repair_planes(self, lost: int) -> list:
        """The planes where chunk ``lost`` is a dot, ascending."""
        n = self.node(lost)
        x, y = n % self.q, n // self.q
        return [z for z in range(self.sub) if self.digit(z, y) == x]

    def helpers(self, lost: int) -> tuple:
        """The d chunks a repair of ``lost`` reads when every other chunk
        is available: the lost node's column first, then the lowest
        chunk ids; ascending."""
        n = self.node(lost)
        y = n // self.q
        column = [c for c in range(self.k + self.m) if c != lost
                  and self.node(c) // self.q == y]
        rest = [c for c in range(self.k + self.m)
                if c != lost and c not in column]
        return tuple(sorted((column + rest)[:self.d]))

    # -- GF(2^8) on tensors ----------------------------------------------

    def _table(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._tables:
            self._tables[key] = gf256.mul_table(device)
        return self._tables[key]

    def _mul(self, c: int, x: torch.Tensor) -> torch.Tensor:
        c = int(c)
        if c == 0:
            return torch.zeros_like(x)
        if c == 1:
            return x
        return self._table(x.device)[c][x.long()]

    def _combine(self, rows: np.ndarray, xs: list) -> list:
        """[xor_j rows[i, j] * xs[j] for each row i]."""
        table = self._table(xs[0].device)
        out = [torch.zeros_like(xs[0]) for _ in range(rows.shape[0])]
        for j, x in enumerate(xs):
            idx = None
            for i in range(rows.shape[0]):
                c = int(rows[i, j])
                if c == 1:
                    out[i] ^= x
                elif c:
                    if idx is None:
                        idx = x.long()
                    out[i] ^= table[c][idx]
        return out

    def _uncouple(self, node, sw, c_node, c_sw):
        """U of ``node`` from both C of its pair."""
        s = self._slot(node, sw)
        inv = self.pft_inv
        return self._mul(inv[s, s], c_node) ^ self._mul(inv[s, 1 - s], c_sw)

    def _type1(self, node, sw, c_node, u_sw):
        """U of ``node`` from its own C and its pair's U."""
        s = self._slot(node, sw)
        p = self.pft
        return self._mul(gf256.gf_inv(int(p[s, s])),
                         c_node ^ self._mul(p[s, 1 - s], u_sw))

    def _couple(self, node, sw, u_node, u_sw):
        """C of ``node`` from both U of its pair."""
        s = self._slot(node, sw)
        return self._mul(self.pft[s, s], u_node) ^ \
            self._mul(self.pft[s, 1 - s], u_sw)

    def _solve_rows(self, erased: tuple) -> tuple:
        """(survivor nodes, rows): each erased node's U from the
        survivors' U in one plane."""
        if erased not in self._rows:
            survivors = tuple(n for n in range(self.nodes)
                              if n not in erased)
            data = gf256.decode_matrix(self.gen[self.kk:], survivors,
                                       tuple(range(self.kk)))
            self._rows[erased] = (survivors,
                                  _mat_mul(self.gen[list(erased)], data))
        return self._rows[erased]

    def _known_u(self, C, U, z, erased):
        """U of every node outside ``erased`` in plane z, into U."""
        for n in range(self.nodes):
            if n in erased:
                continue
            pr = self.pair(n, z)
            if pr is None:
                U[n, z] = C[n, z]
            elif pr[0] in erased:
                U[n, z] = self._type1(n, pr[0], C[n, z], U[pr])
            else:
                U[n, z] = self._uncouple(n, pr[0], C[n, z], C[pr])

    def _solve_plane(self, U, z, erased):
        survivors, rows = self._solve_rows(erased)
        for n, u in zip(erased, self._combine(
                rows, [U[s, z] for s in survivors])):
            U[n, z] = u

    # -- encode and repair -----------------------------------------------

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """(B, k, chunk) uint8 -> (B, m, chunk) parity."""
        b, k, chunk = data.shape
        sc = chunk // self.sub
        if k != self.k or chunk % self.sub:
            raise ValueError(f"need (B, {self.k}, a multiple of "
                             f"{self.sub}), got {tuple(data.shape)}")
        out = torch.empty((b, self.m, chunk), dtype=torch.uint8,
                          device=data.device)
        step = max(1, (1 << 23) // sc)
        for s in range(0, b, step):
            out[s:s + step] = self._encode_block(data[s:s + step])
        return out

    def _encode_block(self, data: torch.Tensor) -> torch.Tensor:
        b, sc = data.shape[0], data.shape[-1] // self.sub
        planes = data.reshape(b, self.k, self.sub, sc)
        zero = torch.zeros((b, sc), dtype=torch.uint8, device=data.device)
        erased = tuple(range(self.kk, self.nodes))
        C, U = {}, {}
        for n in range(self.kk):
            for z in range(self.sub):
                C[n, z] = planes[:, n, z] if n < self.k else zero
        score = [sum(self.digit(z, n // self.q) == n % self.q
                     for n in erased) for z in range(self.sub)]
        for z in sorted(range(self.sub), key=lambda z: score[z]):
            self._known_u(C, U, z, erased)
            self._solve_plane(U, z, erased)
        out = torch.empty((b, self.m, self.sub, sc), dtype=torch.uint8,
                          device=data.device)
        for j, n in enumerate(erased):
            for z in range(self.sub):
                pr = self.pair(n, z)
                out[:, j, z] = U[n, z] if pr is None else \
                    self._couple(n, pr[0], U[n, z], U[pr])
        return out.reshape(b, self.m, self.sub * sc)

    def repair(self, reads: torch.Tensor, lost: int,
               helpers: tuple = None) -> torch.Tensor:
        """(B, d, n_rp * sc) uint8, each helper's repair sub-chunks in
        plane order, helpers ascending -> (B, 1, sub * sc): chunk
        ``lost``."""
        helpers = self.helpers(lost) if helpers is None else helpers
        planes = self.repair_planes(lost)
        n_rp = len(planes)
        b, nh, width = reads.shape
        if nh != self.d or len(helpers) != self.d or width % n_rp:
            raise ValueError(f"need (B, {self.d}, a multiple of {n_rp}) "
                             f"reads, got {tuple(reads.shape)}")
        sc = width // n_rp
        q = self.q
        lnode = self.node(lost)
        x0, y0 = lnode % q, lnode // q
        zero = torch.zeros((b, sc), dtype=torch.uint8, device=reads.device)
        C, U = {}, {}
        hnodes = [self.node(h) for h in helpers]
        split = reads.reshape(b, self.d, n_rp, sc)
        for i, n in enumerate(hnodes):
            for p, z in enumerate(planes):
                C[n, z] = split[:, i, p]
        for n in range(self.k, self.kk):
            for z in range(self.sub):
                C[n, z] = zero
        aloof = [n for n in range(self.nodes) if not self.is_virtual(n)
                 and n != lnode and n not in hnodes]
        column = [y0 * q + x for x in range(q) if x != x0]
        erased = tuple(sorted({lnode, *aloof, *column}))
        if len(erased) != self.m:
            raise ValueError(f"helpers {helpers} cannot repair {lost}")
        score = {z: sum(self.digit(z, n // q) == n % q for n in aloof)
                 for z in planes}
        for z in sorted(planes, key=lambda z: score[z]):
            self._known_u(C, U, z, erased)
            self._solve_plane(U, z, erased)
        out = torch.empty((b, self.sub, sc), dtype=torch.uint8,
                          device=reads.device)
        for z in range(self.sub):
            xp = self.digit(z, y0)
            if xp == x0:
                out[:, z] = U[lnode, z]
                continue
            # the lost vertex pairs with (u, z_rp), z_rp a repair plane
            # where C and U of u are known: solve U of the lost vertex,
            # then couple
            u = y0 * q + xp
            z_rp = z + (x0 - xp) * q ** y0
            su, sl = self._slot(u, lnode), self._slot(lnode, u)
            num = C[u, z_rp] ^ self._mul(self.pft[su, su], U[u, z_rp])
            u_lost = self._mul(gf256.gf_inv(int(self.pft[su, sl])), num)
            out[:, z] = self._couple(lnode, u, u_lost, U[u, z_rp])
        return out.reshape(b, 1, self.sub * sc)

    def repair_composite(self, lost: int) -> np.ndarray:
        """(sub, d * n_rp) GF(2^8) matrix of the repair of ``lost``:
        column t * n_rp + p takes the p-th repair sub-chunk of the t-th
        helper, found by repairing impulses."""
        n_rp = len(self.repair_planes(lost))
        width = self.d * n_rp
        reads = torch.zeros((1, self.d, n_rp, width), dtype=torch.uint8)
        for t in range(self.d):
            for p in range(n_rp):
                reads[0, t, p, t * n_rp + p] = 1
        out = self.repair(reads.reshape(1, self.d, n_rp * width), lost)
        return out.reshape(self.sub, width).numpy().astype(np.int64)


__all__ = ["Clay"]
