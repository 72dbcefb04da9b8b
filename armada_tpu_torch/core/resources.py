"""Resource vocabulary and exact quantity arithmetic.

The design mirrors the role of the reference's resource factory
(internal/scheduler/internaltypes/resource_list_factory.go:20)
but is column-oriented from the start: a ResourceList here is a numpy int64
vector (or a batch of them), not a per-object struct. The factory fixes the
resource-name -> index mapping and, like the reference, converts Kubernetes
quantities to int64 at a per-resource power-of-ten scale derived from the
configured resolution (resource_list_factory.go:61-71). Node quantities round
down, job-request quantities round up, so scheduling stays conservative.

A second, coarser per-resource scale ("device scale") maps the exact int64
host values onto int32 device lanes for the device solve; int32 with e.g.
memory in MiB covers 2 PiB per node, far beyond any real machine. Requests are ceil-scaled and allocatable floor-scaled so a
device-side "fits" never overstates capacity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from fractions import Fraction

import numpy as np

# A batch of request shapes is parsed by the port's C++ parser
# (csrc/quantity.cpp, built at first use by ops/kernels.py
# `load_quantity`), which gives the exact Fraction path's integers;
# `parse_quantity` and `from_map` are the Fraction path.

# Binary and decimal suffixes accepted by Kubernetes resource quantities.
_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DECIMAL = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}


def parse_quantity(value) -> Fraction:
    """Parse a Kubernetes-style resource quantity into an exact Fraction.

    Accepts ints/floats ("1", 0.5) and strings ("100m", "1.5Gi", "2e3").
    """
    if isinstance(value, Fraction):
        return value
    if isinstance(value, (int, np.integer)):
        return Fraction(int(value))
    if isinstance(value, float):
        return Fraction(str(value))
    s = str(value).strip()
    if not s:
        raise ValueError("empty quantity")
    for suffix, mult in _BINARY.items():
        if s.endswith(suffix):
            return Fraction(s[: -len(suffix)]) * mult
    # Suffix check must precede scientific notation: "5E" is 5 exa,
    # while "5e3"/"5E3" (digit last) is scientific.
    if s[-1] in _DECIMAL and not s[-1].isdigit():
        return Fraction(s[:-1]) * _DECIMAL[s[-1]]
    if "e" in s or "E" in s:
        head, _, exp = s.partition("e" if "e" in s else "E")
        return Fraction(head) * Fraction(10) ** int(exp)
    return Fraction(s)


def _resolution_to_scale(resolution) -> int:
    """Power-of-ten scale for a resolution, as in resource_list_factory.go:66.

    "1m"/0.001 -> -3 (store millis), "1" -> 0, "100Mi" -> 8 (1e8 ~ 100Mi).
    Non-positive resolutions default to milli.
    """
    r = parse_quantity(resolution)
    if r <= 0:
        return -3
    return math.floor(math.log10(float(r)))


_factory_serial = 0


@dataclass(frozen=True)
class ResourceListFactory:
    """Fixed resource-name vocabulary with exact int64 host encoding.

    names[i] is the canonical resource at index i; host int64 values are the
    quantity divided by 10^scale[i]. device_scale[i] further divides host
    values for the int32 device tensors.
    """

    names: tuple[str, ...]
    scales: tuple[int, ...]  # power-of-ten per resource (host encoding)
    device_divisor: tuple[int, ...]  # host units per device unit (int32 lanes)
    # True for pool-level floating resources (not attached to nodes).
    floating: tuple[bool, ...] = ()
    name_to_index: dict[str, int] = field(default_factory=dict)
    # Process-unique id tagging rows cached on spec objects (see
    # encode_cached_batch); id() is unsafe across GC reuse.
    serial: int = 0

    @staticmethod
    def create(
        supported: list[tuple[str, object]],
        floating: list[tuple[str, object]] = (),
        device_divisors: dict[str, int] | None = None,
    ) -> "ResourceListFactory":
        """supported/floating: [(name, resolution)], mirroring
        supportedResourceTypes + floatingResourceTypes config."""
        names, scales = [], []
        floating = list(floating)
        floating_flags = []
        for name, resolution in list(supported) + floating:
            if name in names:
                raise ValueError(f"duplicate resource type {name!r}")
            names.append(name)
            scales.append(_resolution_to_scale(resolution))
            floating_flags.append(len(floating_flags) >= len(supported))
        divisors = []
        device_divisors = device_divisors or {}
        for name, scale in zip(names, scales):
            if name in device_divisors:
                divisors.append(int(device_divisors[name]))
            else:
                # Default: keep cpu-like milli resources as-is; compress
                # byte-like resources (scale 0 with huge ranges) to ~Mi.
                divisors.append(1 if scale != 0 else _default_divisor(name))
        global _factory_serial
        _factory_serial += 1
        factory = ResourceListFactory(
            names=tuple(names),
            scales=tuple(scales),
            device_divisor=tuple(divisors),
            floating=tuple(floating_flags),
            serial=_factory_serial,
        )
        factory.name_to_index.update({n: i for i, n in enumerate(names)})
        return factory

    def floating_mask(self) -> np.ndarray:
        return np.asarray(self.floating, dtype=bool)

    @property
    def num_resources(self) -> int:
        return len(self.names)

    def index_of(self, name: str) -> int:
        return self.name_to_index[name]

    # ---- host encoding (exact int64) ----

    def from_map(self, resources: dict, *, ceil: bool, strict: bool = False) -> np.ndarray:
        """Encode {name: quantity} into an int64 vector.

        ceil=True for job requests (round up), False for node allocatable
        (round down), mirroring FromJobResourceListFailOnUnknown vs
        FromNodeProto (resource_list_factory.go:87-120). Unknown resources are
        ignored unless strict.
        """
        out = np.zeros(self.num_resources, dtype=np.int64)
        for name, quantity in (resources or {}).items():
            i = self.name_to_index.get(name)
            if i is None:
                if strict:
                    raise KeyError(f"unknown resource {name!r}")
                continue
            scaled = parse_quantity(quantity) / (Fraction(10) ** self.scales[i])
            value = int(math.ceil(scaled) if ceil else math.floor(scaled))
            # Saturate: absurd quantities (e.g. "1Ei" at byte scale) clamp
            # rather than crash, matching the native parser.
            out[i] = min(max(value, -(2**63)), 2**63 - 1)
        return out

    def encode_requests_batch(self, requests: list, *, ceil: bool) -> np.ndarray:
        """Encode a batch of {name: quantity} dicts into int64[J, R].

        Distinct request shapes are parsed once (real workloads submit
        thousands of identical specs), by the compiled parser
        (csrc/quantity.cpp: exact int128 arithmetic, the Fraction path's
        integers; built at first use, and a failed build raises). The
        Fraction path is `from_map`, one request at a time.
        """
        J = len(requests)
        R = self.num_resources
        # Uniquify by item tuple: one parse per distinct request dict.
        keys = [
            tuple(sorted(r.items())) if r else () for r in requests
        ]
        uniq_idx: dict = {}
        uniq_reqs: list = []
        rows = np.empty(J, dtype=np.int64)
        for j, k in enumerate(keys):
            i = uniq_idx.get(k)
            if i is None:
                i = len(uniq_reqs)
                uniq_idx[k] = i
                uniq_reqs.append(requests[j])
            rows[j] = i
        parsed = self._encode_unique(uniq_reqs, ceil=ceil)
        return parsed[rows] if J else np.zeros((0, R), dtype=np.int64)

    def encode_cached_batch(self, objs: list, get, *, ceil: bool, tag: str) -> np.ndarray:
        """encode_requests_batch with a per-object row cache.

        The scheduler re-snapshots the same JobSpec/NodeSpec objects every
        cycle; their encoded rows never change, so each object carries its
        row (stored via object.__setattr__ — the spec dataclasses are
        frozen but not slotted), tagged with (factory serial, ceil, tag) so
        a different factory or rounding mode never reads a stale row. Warm
        cycles skip all quantity parsing: cost is one dict probe per
        object. `get(obj)` returns the {name: quantity} dict for misses."""
        J = len(objs)
        rows = np.empty((J, self.num_resources), dtype=np.int64)
        want = (self.serial, ceil, tag)
        misses: list = []
        miss_at: list = []
        for j, obj in enumerate(objs):
            cached = obj.__dict__.get("_enc_row")
            if cached is not None and cached[0] == want:
                rows[j] = cached[1]
            else:
                misses.append(obj)
                miss_at.append(j)
        if misses:
            enc = self.encode_requests_batch(
                [get(o) for o in misses], ceil=ceil
            )
            for k, obj in enumerate(misses):
                rows[miss_at[k]] = enc[k]
                # Copy: enc[k] is a view whose base is the full [misses, R]
                # batch; caching the view would pin the whole batch in
                # memory for as long as any one job object lives.
                object.__setattr__(obj, "_enc_row", (want, enc[k].copy()))
        return rows

    def _encode_unique(self, requests: list, *, ceil: bool) -> np.ndarray:
        U = len(requests)
        if U:
            from ..ops.kernels import load_quantity

            parser = load_quantity()
            try:
                raw = parser.encode_requests(
                    list(requests), list(self.names), list(self.scales), ceil
                )
                return np.frombuffer(raw, dtype=np.int64).reshape(U, self.num_resources).copy()
            except (ValueError, TypeError):
                # The Fraction path accepts a slightly wider grammar (e.g.
                # Fraction instances, "1e3Ki"): such a batch takes it, so the
                # grammar is the Fraction path's whichever parser runs.
                pass
        out = np.zeros((U, self.num_resources), dtype=np.int64)
        for j, req in enumerate(requests):
            out[j] = self.from_map(req, ceil=ceil)
        return out

    def to_map(self, vec: np.ndarray) -> dict[str, Fraction]:
        """Decode an int64 vector back to {name: exact quantity}."""
        return {
            name: Fraction(int(vec[i])) * Fraction(10) ** self.scales[i]
            for i, name in enumerate(self.names)
            if vec[i] != 0
        }

    def zeros(self, *batch: int) -> np.ndarray:
        return np.zeros((*batch, self.num_resources), dtype=np.int64)

    # ---- device encoding (int32 lanes) ----

    def to_device(self, host_vals: np.ndarray, *, ceil: bool) -> np.ndarray:
        """Scale host int64 values to int32 device units.

        Requests ceil, allocatable floor: a device-side fit check is then
        always at least as strict as the exact host check.
        """
        div = np.asarray(self.device_divisor, dtype=np.int64)
        v = np.asarray(host_vals, dtype=np.int64)
        scaled = -((-v) // div) if ceil else v // div
        lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        return np.clip(scaled, lo, hi).astype(np.int32)


def _default_divisor(name: str) -> int:
    byte_like = ("memory", "storage", "disk", "ephemeral")
    if any(t in name for t in byte_like):
        return 2**20  # Mi
    return 1
