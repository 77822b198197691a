"""Roofline terms of a step on the NVIDIA H100. Twin of
``repro.distributed.roofline``, re-based on the H100's figures.

Hardware model: one H100 SXM (NVIDIA's data sheet, dense rates at the
700 W limit) — 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3,
and NVLink 4 at 450 GB/s per direction (18 links at 25 GB/s each way).

The reference reads its terms off a compiled XLA module
(``cost_analysis()``, the optimized HLO's collectives,
``memory_analysis()``). A PyTorch step has no such module, so
:func:`from_step` takes them from one uncaptured run of the step:

* FLOPs and bytes: :func:`repro_torch.core.energy.backbone_cost` (every
  product ``FlopCounterMode`` sees; each rank's weights once a frame at
  their dtype, the frame in, the logits out), summed over the ranks;
* collective bytes: :func:`repro_torch.distributed.sharding.count_collectives`
  over the same run, per rank, as the reference's HLO shapes are per
  device;
* peak memory: the allocator's peak over the run on the card (0.0 on the
  CPU).

:func:`from_counts` takes the same terms for a train or prefill cell from
one run of a rank's step on meta tensors (the dry run,
:mod:`repro_torch.launch.dryrun`): FLOPs from ``FlopCounterMode``, bytes
from every op's inputs and outputs, collectives from ``count_collectives``
and the peak from :func:`repro_torch.distributed.memory_model.analyze`.

:class:`Roofline` keeps the reference's fields, properties and
``to_dict()`` keys, so one table renders the records of both packages.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import energy
from repro_torch.distributed import memory_model, sharding

PEAK_FLOPS = 989e12        # bf16 / card (tensor cores, dense)
HBM_BW = 3.35e12           # bytes/s / card
ICI_BW = 450e9             # bytes/s / card, NVLink 4, per direction


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float            # total across chips
    hlo_gbytes: float
    coll_gbytes: float
    coll_breakdown: dict = field(default_factory=dict)
    model_gflops: float = 0.0    # 6*N*D useful flops
    per_device_peak_mem_gb: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_gflops * 1e9 / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_gbytes * 1e9 / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        # coll_gbytes is the PER-DEVICE payload, over one card's NVLink in
        # one direction
        return self.coll_gbytes * 1e9 / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        return (self.model_gflops / self.hlo_gflops) if self.hlo_gflops \
            else 0.0

    @property
    def roofline_fraction(self) -> float:
        """T_compute / max-term: 1.0 = compute-bound at peak."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t else 0.0

    @property
    def model_roofline_fraction(self) -> float:
        """Useful-FLOPs roofline fraction (penalizes remat/redundancy):
        time at peak for MODEL_FLOPS / dominant term."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        t_model = self.model_gflops * 1e9 / (self.chips * PEAK_FLOPS)
        return t_model / t if t else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flop_ratio=self.useful_flop_ratio,
                 roofline_fraction=self.roofline_fraction,
                 model_roofline_fraction=self.model_roofline_fraction)
        return d


def model_flops(cfg, shape, n_params: int) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) useful training FLOPs; forward
    only (2*N*D) for prefill; 2*N_active per token for decode."""
    tokens = shape.global_batch * shape.seq_len
    n_active = active_params(cfg, n_params)
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active * shape.global_batch


def active_params(cfg, n_params: int) -> float:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    if not cfg.n_experts:
        return float(n_params)
    # expert weights fraction: 3 matrices of (d_model x d_ff) per expert
    per_expert = 3 * cfg.d_model * cfg.d_ff
    expert_total = cfg.n_layers * cfg.n_experts * per_expert
    non_expert = n_params - expert_total
    return float(non_expert + cfg.n_layers * cfg.top_k * per_expert)


def from_step(step_fn, weights, frames: torch.Tensor, *, arch: str, shape,
              mesh_name: str, chips: int, cfg=None,
              n_params: int = 0) -> Roofline:
    """The roofline of one ``step_fn(weights, frames)`` (a batch) from one
    uncaptured run of it; on a mesh of ``chips`` ranks, ``weights`` are
    this rank's blocks and every rank calls this together (the run issues
    the step's collectives)."""
    cuda = frames.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(frames.device)
        torch.cuda.reset_peak_memory_stats(frames.device)
    with sharding.count_collectives() as coll:
        cost = energy.backbone_cost(step_fn, weights, frames, ranks=chips)
    peak = 0
    if cuda:
        torch.cuda.synchronize(frames.device)
        peak = torch.cuda.max_memory_allocated(frames.device)
    batch = frames.shape[0]
    mf = model_flops(cfg, shape, n_params) if cfg is not None else 0.0
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_gflops=cost.flops * batch / 1e9,
        hlo_gbytes=cost.bytes * batch / 1e9,
        coll_gbytes=sum(coll.bytes.values()) / 1e9,
        coll_breakdown={k: v / 1e9 for k, v in coll.bytes.items() if v},
        model_gflops=mf / 1e9,
        per_device_peak_mem_gb=peak / 1e9,
    )


class _OpBytes(TorchDispatchMode):
    """Sums the bytes of every tensor each op reads and writes (its tensor
    arguments and outputs), views and the collectives' own ops left out:
    the traffic of eager PyTorch, each op its own pass through memory."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.namespace != "c10d":
            self.bytes += sum(t.numel() * t.element_size() for t in
                              tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def from_counts(step_fn, args, *, arch: str, shape, mesh, mesh_name: str,
                cfg, n_params: int, rules: dict | None = None) -> Roofline:
    """The roofline of one train or prefill step of ``cfg`` at ``shape``
    from one run of ``step_fn(*args)``, this rank's step on ``mesh``
    (every rank of which calls this together; on meta tensors under a
    fake process group, one process counts a rank of any mesh):

    * ``hlo_gflops``: the run's products (``FlopCounterMode``) times the
      mesh's ranks, every layer and every backward product counted (the
      ranks run the same program on blocks of the same shapes);
    * ``hlo_gbytes``: the bytes every op reads and writes times the ranks,
      the traffic of eager PyTorch, not of a fused program: an upper
      bound on what the step must move;
    * ``coll_gbytes``: the collectives' output bytes, per rank, as the
      reference's HLO shapes are per device;
    * ``per_device_peak_mem_gb``: :func:`memory_model.analyze` of the
      cell on ``mesh`` (meta tensors have no allocator);
    * ``model_gflops``: :func:`model_flops`."""
    chips = mesh.size()
    with sharding.count_collectives() as coll, \
            FlopCounterMode(display=False) as fc, _OpBytes() as ob:
        step_fn(*args)
    mem = memory_model.analyze(cfg, shape, mesh, rules)
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_gflops=fc.get_total_flops() * chips / 1e9,
        hlo_gbytes=ob.bytes * chips / 1e9,
        coll_gbytes=sum(coll.bytes.values()) / 1e9,
        coll_breakdown={k: v / 1e9 for k, v in coll.bytes.items() if v},
        model_gflops=model_flops(cfg, shape, n_params) / 1e9,
        per_device_peak_mem_gb=mem.total_gb)
