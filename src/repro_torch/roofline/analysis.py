"""Roofline analysis from a traced dry-run step (no real hardware).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs / (chips x peak_FLOP/s)
    memory     = bytes / (chips x HBM_bw)
    collective = collective_bytes / (chips x link_bw)

The reference reads FLOPs and bytes from XLA's cost analysis of a
compiled module and parses the collectives out of its HLO. The port has
no compiler between the step and the device, so `CellCounter` counts the
step as it runs on fake tensors: a TorchDispatchMode that lets DTensor
lower every sharded op to its local ops and collectives first, then counts
those on the local shards of one device (rank 0):

  - FLOPs: torch.utils.flop_counter's formulas on the local shapes (dense
    products and attention; elementwise ops count 0, as in XLA's count of
    dots);
  - bytes accessed: each op's local input bytes plus the bytes of outputs
    that are not its inputs; views move nothing and count 0. Nothing is
    fused, so this reads more than XLA's "bytes accessed";
  - collective bytes: the operands of the functional collectives that
    DTensor's redistributions issue, by the reference's five kinds
    (all_gather_into_tensor -> all-gather, reduce_scatter_tensor ->
    reduce-scatter, all_reduce, all_to_all_single; nothing issues a
    collective-permute).

Hardware model: NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W power limit,
data-sheet rates. One link figure: a 16-wide model axis spans two 8-card
hosts, and LINK_BW, the NVLink rate inside a host, does not model the
network between hosts, just as the reference's one ICI figure does not
model its pods' links.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 80GB HBM3, 700.00 W: bf16 dense tensor-core peak per card
PEAK_FLOPS = 989e12
# NVIDIA H100 80GB HBM3, 700.00 W: HBM3 bytes/s per card
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700.00 W: NVLink bytes/s each way per card
LINK_BW = 450e9
# NVIDIA H100 80GB HBM3, 700.00 W: device memory as
# torch.cuda.get_device_properties(0).total_memory reads it
HBM_PER_CHIP = 85_017_493_504

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# functional collectives (native, legacy and autograd namespaces) by kind
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_FUNCOL_NAMESPACES = ("_c10d_functional", "c10d_functional",
                      "_c10d_functional_autograd")


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)
        elif isinstance(x, dict):
            yield from _tensors(x.values())


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_kind(func) -> str | None:
    """The reference's kind of a functional collective op, else None."""
    ns, _, name = str(func._overloadpacket).rpartition(".")
    if ns.rsplit(".", 1)[-1] not in _FUNCOL_NAMESPACES:
        return None
    return _FUNCOL_KIND.get(name)


class CellCounter(TorchDispatchMode):
    """Counts FLOPs, bytes accessed and collective operand bytes of what
    runs under it, per device. Ops on DTensors are handed back to DTensor
    (NotImplemented), which runs them as local ops and collectives that
    come back here. DTensor's sharding propagation must run outside it
    (launch/dryrun.py::_dtensor_patches): its global-shape ops are not the
    device's."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective = {k: 0 for k in COLLECTIVE_OPS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = collective_kind(func)
        if kind is not None:
            self.collective[kind] += sum(nbytes(t) for t in _tensors(args))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:
            ins = list(_tensors((args, kwargs)))
            ids = {id(t) for t in ins}
            outs = [t for t in _tensors((out,)) if id(t) not in ids]
            self.bytes += sum(nbytes(t) for t in ins + outs)
        return out

    @property
    def collective_total(self) -> int:
        return sum(self.collective.values())


@dataclasses.dataclass
class Roofline:
    name: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    collective_by_kind: dict | None = None

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def model_flops_ratio(self, model_flops_total: float) -> float:
        """MODEL_FLOPS / counted FLOPs: how much traced compute is useful."""
        hlo_total = self.flops_per_device * self.chips
        return model_flops_total / hlo_total if hlo_total else 0.0

    def roofline_fraction(self, model_flops_total: float) -> float:
        """useful-FLOPs time at peak / bound time."""
        useful_s = model_flops_total / (self.chips * self.peak_flops)
        return useful_s / self.bound_s if self.bound_s else 0.0

    def to_dict(self, model_flops_total: float | None = None) -> dict:
        d = {
            "name": self.name,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
        }
        if model_flops_total is not None:
            d["model_flops"] = model_flops_total
            d["model_flops_ratio"] = self.model_flops_ratio(model_flops_total)
            d["roofline_fraction"] = self.roofline_fraction(model_flops_total)
        return d


def from_counts(name: str, counter: CellCounter, chips: int) -> Roofline:
    """The counterpart of the reference's from_compiled: a Roofline of
    one traced step's per-device counts, collective_by_kind set."""
    r = Roofline(name=name, chips=chips,
                 flops_per_device=float(counter.flops),
                 bytes_per_device=float(counter.bytes),
                 collective_bytes_per_device=float(counter.collective_total))
    r.collective_by_kind = dict(counter.collective)
    return r


def model_flops(n_params_active: float, tokens: float,
                train: bool) -> float:
    """6·N·D for a train step (fwd+bwd), 2·N·D for inference."""
    return (6.0 if train else 2.0) * n_params_active * tokens
