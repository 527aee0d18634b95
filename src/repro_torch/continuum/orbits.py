"""Orbital mechanics for a Walker-delta LEO constellation + ground sites.

Circular orbits, spherical Earth: position(t) from plane RAAN + phase; the
Earth rotates under the constellation, so ground-station visibility changes
continuously — the paper's "satellites move in and out of range" dynamic,
modeled more faithfully than its tc-based testbed (paper §6.6 discussion).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

R_EARTH = 6_371_000.0          # m
MU = 3.986004418e14            # m^3/s^2
C_LIGHT = 299_792_458.0        # m/s
OMEGA_EARTH = 7.2921159e-5     # rad/s


def _rot_z(v, ang):
    c, s = math.cos(ang), math.sin(ang)
    return (c * v[0] - s * v[1], s * v[0] + c * v[1], v[2])


def _rot_x(v, ang):
    c, s = math.cos(ang), math.sin(ang)
    return (v[0], c * v[1] - s * v[2], s * v[1] + c * v[2])


@dataclass(frozen=True)
class OrbitalElement:
    altitude: float          # m
    inclination: float       # rad
    raan: float              # rad (right ascension of ascending node)
    phase: float             # rad (initial anomaly)

    @property
    def radius(self) -> float:
        return R_EARTH + self.altitude

    @property
    def angular_rate(self) -> float:
        return math.sqrt(MU / self.radius ** 3)

    def position(self, t: float) -> Tuple[float, float, float]:
        """ECI position at time t (m).

        Inclination/RAAN/rate are constant per element, so their trig is
        computed once and reused — ``position`` runs per satellite per
        topology snapshot, and libm calls dominated the snapshot build.
        The rotation arithmetic matches ``_rot_x``/``_rot_z`` exactly, so
        values are bit-identical to the unmemoized form."""
        memo = self.__dict__.get("_memo")
        if memo is None:
            memo = (self.radius, self.angular_rate,
                    math.cos(self.inclination), math.sin(self.inclination),
                    math.cos(self.raan), math.sin(self.raan))
            object.__setattr__(self, "_memo", memo)
        radius, rate, ci, si, cr, sr = memo
        ang = self.phase + rate * t
        x, y = radius * math.cos(ang), radius * math.sin(ang)
        # _rot_x(v, inclination) with v = (x, y, 0.0): z' = si*y + ci*0.0
        yi, zi = ci * y - si * 0.0, si * y + ci * 0.0
        # _rot_z(v, raan)
        return (cr * x - sr * yi, sr * x + cr * yi, zi)


@dataclass(frozen=True)
class GroundSite:
    """Fixed site on the rotating Earth (cloud DC, edge node, drone zone)."""
    lat: float               # rad
    lon: float               # rad
    altitude: float = 0.0

    def position(self, t: float) -> Tuple[float, float, float]:
        # lat trig and radius are constant per site — memoized (the
        # expressions below match the unmemoized form bit-exactly)
        memo = self.__dict__.get("_memo")
        if memo is None:
            memo = (R_EARTH + self.altitude, math.cos(self.lat),
                    math.sin(self.lat))
            object.__setattr__(self, "_memo", memo)
        r, cl, sl = memo
        lon = self.lon + OMEGA_EARTH * t
        return (r * cl * math.cos(lon), r * cl * math.sin(lon), r * sl)


def distance(a, b) -> float:
    return math.sqrt(sum((x - y) ** 2 for x, y in zip(a, b)))


def line_of_sight(a, b, margin: float = 100_000.0) -> bool:
    """True when the segment a-b clears the Earth (chord height test)."""
    ax, ay, az = a
    dx = (b[0] - ax, b[1] - ay, b[2] - az)
    L2 = dx[0] ** 2 + dx[1] ** 2 + dx[2] ** 2
    if L2 == 0:
        return True
    t = -(ax * dx[0] + ay * dx[1] + az * dx[2]) / L2
    t = min(max(t, 0.0), 1.0)
    px = (ax + t * dx[0], ay + t * dx[1], az + t * dx[2])
    return math.sqrt(px[0] ** 2 + px[1] ** 2 + px[2] ** 2) \
        > R_EARTH + margin


def visible_from_ground(site_pos, sat_pos, min_elevation_deg: float = 10.0
                        ) -> bool:
    """Elevation-mask visibility test."""
    sx = [b - a for a, b in zip(site_pos, sat_pos)]
    r = math.sqrt(sum(x * x for x in site_pos))
    up = [x / r for x in site_pos]
    d = math.sqrt(sum(x * x for x in sx))
    if d == 0:
        return True
    sin_el = sum(u * s for u, s in zip(up, sx)) / d
    return sin_el >= math.sin(math.radians(min_elevation_deg))


class Constellation:
    """Walker-delta: ``n_planes`` x ``sats_per_plane`` at ``altitude``."""

    def __init__(self, n_planes: int = 6, sats_per_plane: int = 8,
                 altitude: float = 550_000.0,
                 inclination_deg: float = 53.0, phasing: float = 0.5):
        self.n_planes = n_planes
        self.sats_per_plane = sats_per_plane
        self.elements: List[OrbitalElement] = []
        inc = math.radians(inclination_deg)
        for p in range(n_planes):
            raan = 2 * math.pi * p / n_planes
            for s in range(sats_per_plane):
                phase = 2 * math.pi * (s + phasing * p / n_planes) \
                    / sats_per_plane
                self.elements.append(
                    OrbitalElement(altitude, inc, raan, phase))

    def __len__(self):
        return len(self.elements)

    def sat_id(self, idx: int) -> str:
        return f"sat{idx}"

    def position(self, idx: int, t: float):
        return self.elements[idx].position(t)

    def isl_neighbors(self, idx: int) -> List[int]:
        """Grid+ ISL topology: fore/aft in plane, left/right cross-plane."""
        p, s = divmod(idx, self.sats_per_plane)
        n = []
        n.append(p * self.sats_per_plane + (s + 1) % self.sats_per_plane)
        n.append(p * self.sats_per_plane + (s - 1) % self.sats_per_plane)
        n.append(((p + 1) % self.n_planes) * self.sats_per_plane + s)
        n.append(((p - 1) % self.n_planes) * self.sats_per_plane + s)
        return n


def propagation_latency(a, b, processing: float = 0.0005) -> float:
    """One-way latency: slant range / c + per-hop processing."""
    return distance(a, b) / C_LIGHT + processing


# ---------------------------------------------------------------------------
# Batched geometry (numpy) — BIT-IDENTICAL to the scalar predicates above.
#
# The snapshot builder evaluates ~600 pair predicates per topology quantum;
# at 100k-instance scale that is millions of Python-level tuple ops, so the
# pairwise tests are vectorized.  Every expression below replicates its
# scalar counterpart operation-for-operation in the SAME association order:
# +,-,*,/ and sqrt are IEEE-754 correctly rounded in both numpy and CPython,
# and ``np.float_power`` reproduces CPython's ``x ** 2`` (libm pow) exactly
# — numpy's ``arr ** 2`` does NOT (it lowers to ``x * x``, which differs
# from pow(x, 2.0) in the last ulp for ~0.1% of inputs).  Positions
# themselves stay scalar ``math`` trig: libm sin/cos are not correctly
# rounded, so vectorizing THEM would change values.
# ``tests/test_continuum.py`` pins scalar/batched equality exactly.
# ---------------------------------------------------------------------------
def _pow2(x):
    """CPython ``x ** 2`` (libm pow) semantics, elementwise."""
    return np.float_power(x, 2.0)


def propagation_latency_batch(a, b, processing: float = 0.0005):
    """``propagation_latency`` over position arrays of shape (n, 3)."""
    d2 = _pow2(a[:, 0] - b[:, 0])
    d2 = d2 + _pow2(a[:, 1] - b[:, 1])
    d2 = d2 + _pow2(a[:, 2] - b[:, 2])
    return np.sqrt(d2) / C_LIGHT + processing


def line_of_sight_batch(a, b, margin: float = 100_000.0):
    """``line_of_sight`` over position arrays of shape (n, 3) -> bool[n]."""
    ax, ay, az = a[:, 0], a[:, 1], a[:, 2]
    d0, d1, d2 = b[:, 0] - ax, b[:, 1] - ay, b[:, 2] - az
    L2 = _pow2(d0) + _pow2(d1) + _pow2(d2)
    degenerate = L2 == 0.0
    # masked divide: non-degenerate lanes get exactly ``num / L2``;
    # degenerate lanes (forced to 0) are overridden by the mask below.
    # (np.errstate would work too, but the context manager showed up in
    # profiles at one snapshot build per simulated second.)
    t = np.divide(-((ax * d0 + ay * d1) + az * d2), L2,
                  out=np.zeros_like(L2), where=~degenerate)
    t = np.minimum(np.maximum(t, 0.0), 1.0)
    norm2 = _pow2(ax + t * d0) + _pow2(ay + t * d1) + _pow2(az + t * d2)
    return degenerate | (np.sqrt(norm2) > R_EARTH + margin)


def visible_from_ground_batch(site_pos, sat_pos,
                              min_elevation_deg: float = 10.0):
    """``visible_from_ground`` for ONE site against sats (n, 3) -> bool[n]."""
    s0, s1, s2 = site_pos
    x0 = sat_pos[:, 0] - s0
    x1 = sat_pos[:, 1] - s1
    x2 = sat_pos[:, 2] - s2
    r = math.sqrt((s0 * s0 + s1 * s1) + s2 * s2)
    u0, u1, u2 = s0 / r, s1 / r, s2 / r
    d = np.sqrt((x0 * x0 + x1 * x1) + x2 * x2)
    degenerate = d == 0.0
    # masked divide (see line_of_sight_batch): degenerate lanes are True
    # via the mask, so their forced-0 quotient is never consulted
    sin_el = np.divide((u0 * x0 + u1 * x1) + u2 * x2, d,
                       out=np.zeros_like(d), where=~degenerate)
    return degenerate | (sin_el >= math.sin(math.radians(min_elevation_deg)))
