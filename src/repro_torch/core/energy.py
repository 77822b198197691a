"""End-to-end energy model (paper §V-E, Fig. 17, Table III).

NumPy copy of ``repro.core.energy`` kept inside the port (SciPy's
``least_squares`` in :func:`calibrate`), so that ``repro_torch`` imports
nothing of the JAX package. It bills the port's
:class:`~repro_torch.core.sensor_control.CaptureLog`, which has the same
fields. ``backbone_cost`` reads a compiled XLA step and is not copied
(its PyTorch form comes with the gated cascade).

Per-frame energy accounting for three system variants:

* ``conventional``        — high-precision ADC always on, every frame
  transmitted (3G) and processed by the cloud model.
* ``compressive_sensing`` — conventional + bit-depth compression (BDC [11])
  on the transmitted payload.
* ``hypersense``          — low-precision path + near-sensor HDC always on;
  the high-precision ADC, transmission and cloud model run only on frames
  the gate passes. Duty cycle ``d = (1-p)*FPR + p*TPR`` for object
  probability ``p`` at the chosen ROC operating point.

Constants are literature-grounded defaults (documented inline); because the
paper does not publish its exact per-component numbers, :func:`calibrate`
can least-squares fit the 3 free scale constants against Table III, and the
benchmark reports both default and calibrated reproductions.

Energy component sources:
  sensor RF front-end: TI AWR1843 ~30 W at 60 fps  -> 0.5 J/frame [21,34],
    split ~50/50 between RF chain (ungated) and ADC+digital (gated).
  low-precision ADC: energy/conversion scales ~2^bits (SAR model) [29]
  HDC near-sensor accel: 8.2 W FPGA at 303 fps (paper Table II) -> 27 mJ
  3G transmission: ~2.5 J/Mbit (typical 3G radio energy)
  cloud inference + PUE: server-side CNN inference per [31]-style estimate.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np


@dataclass(frozen=True)
class EnergyParams:
    # --- per-frame Joules ---
    rf_frontend_j: float = 0.25      # ungated analog front-end
    adc_hp_j: float = 0.25           # high-precision ADC + digital capture
    adc_lp_bits: int = 4             # low-precision ADC bit depth
    adc_hp_bits: int = 12            # high-precision ADC bit depth
    hdc_accel_j: float = 0.027       # 8.2 W / 303 fps  (paper Table II/V-D)
    #: relative energy of the int8 datapath's near-sensor HDC work vs the
    #: float32 path. int8 MAC switching energy is ~0.15-0.3x fp32
    #: (Horowitz, ISSCC'14: 8b add 0.03 pJ vs fp32 add 0.9 pJ; 8b mult
    #: 0.2 pJ vs fp32 mult 3.7 pJ) and operand memory traffic is 4x
    #: smaller; 0.35 is a conservative blended factor in line with the
    #: SCM always-on accelerator's low-bitwidth datapath [Eggimann 2021].
    hdc_int8_factor: float = 0.35
    #: int4 datapath factor: halved operand traffic vs int8 (two codes
    #: per wire byte) on top of the sub-byte MAC scaling — multiplier
    #: energy scales ~quadratically in operand width (Horowitz, ISSCC'14),
    #: so 4b work sits well under the int8 blend; 0.22 keeps the same
    #: conservatism as the 0.35 int8 factor.
    hdc_int4_factor: float = 0.22
    #: binary (±1 slab/class) datapath factor: the multiplies degenerate
    #: to sign-conditioned adds (XOR-popcount in the SCM accelerator,
    #: Eggimann 2021, which runs binarized at ~5 uW; Basaklar 2021 report
    #: order-of-magnitude energy wins for 1-bit hypervectors). 0.12 is a
    #: conservative blend — code traffic and the float epilogue are
    #: unchanged, so it does not approach the raw 1b/8b MAC ratio.
    hdc_binary_factor: float = 0.12
    frame_bits: float = 128 * 128 * 8
    comm_j_per_mbit: float = 2.5     # 3G radio
    cloud_j: float = 6.0             # server inference + network + PUE
    bdc_ratio: float = 0.5           # compressive-sensing payload ratio [11]

    @property
    def adc_lp_j(self) -> float:
        """SAR-ADC energy ~ 2^bits: lp = hp * 2^(lp_bits - hp_bits) [29]."""
        return self.adc_hp_j * (2.0 ** (self.adc_lp_bits - self.adc_hp_bits))

    @property
    def comm_j(self) -> float:
        return self.comm_j_per_mbit * self.frame_bits / 1e6


@dataclass(frozen=True)
class EnergyBreakdown:
    sensor: float
    adc: float
    hdc: float
    comm: float
    cloud: float

    @property
    def edge(self) -> float:
        return self.sensor + self.adc + self.hdc + self.comm

    @property
    def total(self) -> float:
        return self.edge + self.cloud


def conventional(params: EnergyParams = EnergyParams()) -> EnergyBreakdown:
    return EnergyBreakdown(sensor=params.rf_frontend_j, adc=params.adc_hp_j,
                           hdc=0.0, comm=params.comm_j, cloud=params.cloud_j)


def compressive_sensing(params: EnergyParams = EnergyParams()
                        ) -> EnergyBreakdown:
    """BDC compression shrinks the payload, everything else unchanged."""
    return EnergyBreakdown(sensor=params.rf_frontend_j, adc=params.adc_hp_j,
                           hdc=0.0, comm=params.comm_j * params.bdc_ratio,
                           cloud=params.cloud_j)


def duty_cycle(fpr: float, tpr: float, p_object: float) -> float:
    """Fraction of frames the gate passes to the expensive path."""
    return (1.0 - p_object) * fpr + p_object * tpr


def _hdc_j(params: EnergyParams, precision: str) -> float:
    """Per-scored-frame HDC accelerator energy for a datapath precision.

    The ONE precision->cost rule both accounts share, so
    :func:`from_capture_log` can never disagree with
    :func:`hypersense_measured` about the same ``precision`` argument.
    """
    factors = {"float32": 1.0,
               "int8": params.hdc_int8_factor,
               "int4": params.hdc_int4_factor,
               "binary": params.hdc_binary_factor}
    if precision not in factors:
        raise ValueError(f"unknown datapath precision {precision!r}")
    return params.hdc_accel_j * factors[precision]


def hypersense_measured(duty: float,
                        params: EnergyParams = EnergyParams(),
                        precision: str = "float32") -> EnergyBreakdown:
    """Per-frame energy at a *measured* duty cycle (e.g. from StreamStats).

    The analytic :func:`hypersense` predicts the duty cycle from an ROC
    operating point; this variant takes the duty cycle a stream driver
    actually observed — the form the fleet runtime aggregates over sensors.

    ``precision="int8"`` bills the always-on near-sensor HDC work at the
    integer datapath's reduced switching/memory cost
    (``hdc_int8_factor``); the gated high-precision side is unchanged —
    the gate's *decisions*, not its arithmetic, control that.
    """
    hdc = _hdc_j(params, precision)
    return EnergyBreakdown(
        sensor=params.rf_frontend_j,
        adc=params.adc_lp_j + duty * params.adc_hp_j,
        hdc=hdc,
        comm=duty * params.comm_j,
        cloud=duty * params.cloud_j,
    )


def hypersense(fpr: float, tpr: float, p_object: float = 0.01,
               params: EnergyParams = EnergyParams(),
               precision: str = "float32") -> EnergyBreakdown:
    return hypersense_measured(duty_cycle(fpr, tpr, p_object), params,
                               precision)


def adc_conversion_j(bits: int, params: EnergyParams = EnergyParams()
                     ) -> float:
    """Per-frame conversion energy at an arbitrary bit depth.

    The SAR-ADC model [29] anchored at the high-precision point:
    energy/conversion scales ~``2^bits``, so
    ``adc_conversion_j(params.adc_lp_bits) == params.adc_lp_j`` exactly.
    """
    return params.adc_hp_j * (2.0 ** (bits - params.adc_hp_bits))


def _resolve_log_bits(log, params: EnergyParams,
                      on_missing_bits: str) -> tuple[int, int]:
    """The explicit ``None``-depth policy for capture-log billing.

    A log records ``lp_bits``/``hp_bits`` = ``None`` when the runner had
    no explicit depth configured (open loop: ``adc_bits=None`` /
    ``control=None``). Billing must decide what that means — callers must
    NOT paper over it by substituting depths themselves:

    * ``"params"`` — the open-loop convention: bill at the
      :class:`EnergyParams` default depths. This is what makes an
      open-loop run reduce exactly to :func:`hypersense_measured`.
    * ``"error"`` — refuse: the caller claims to know the real burst
      depth (e.g. the gated cascade billing actual backbone input), so a
      ``None`` is a wiring bug, not a convention.
    """
    if on_missing_bits not in ("params", "error"):
        raise ValueError(f"on_missing_bits must be 'params' or 'error', "
                         f"got {on_missing_bits!r}")
    if on_missing_bits == "error" and log.hp_bits is None:
        raise ValueError(
            "capture log has hp_bits=None (open-loop run: no "
            "CaptureConfig) but this billing requires the real burst "
            "depth — run the producer with control=CaptureConfig(...) or "
            "bill with on_missing_bits='params'")
    lp_bits = params.adc_lp_bits if log.lp_bits is None else log.lp_bits
    hp_bits = params.adc_hp_bits if log.hp_bits is None else log.hp_bits
    return lp_bits, hp_bits


def from_capture_log(log, params: EnergyParams | None = None,
                     precision: str = "float32",
                     on_missing_bits: str = "params") -> EnergyBreakdown:
    """Per-frame mean energy billed from what was *actually* captured.

    ``log`` is a :class:`~repro_torch.core.sensor_control.CaptureLog` (duck —
    anything with ``sampled``/``gated`` arrays and ``lp_bits``/``hp_bits``
    depths): each LP conversion made, each HP burst conversion made, and
    each frame transmitted is billed individually — the near-sensor HDC
    accelerator only runs on frames the LP ADC converted. This replaces
    the duty-fraction approximation of :func:`hypersense_measured` as the
    runtime's primary account: when the closed loop subsamples idle
    frames, the LP-side energy drops below the always-on term
    ``adc_lp_j + hdc_accel_j`` that approximation bills unconditionally.

    ``None`` depths are handled here, explicitly, by ``on_missing_bits``
    (see :func:`_resolve_log_bits`) — never by the log's producer: the
    default ``"params"`` is the open-loop convention, ``"error"`` rejects
    logs without a real recorded burst depth.

    When every frame is sampled and the log's depths equal the params'
    (the open-loop regime), this reduces *exactly* to
    ``hypersense_measured(duty)``, field for field.
    """
    params = params or EnergyParams()
    sampled = np.asarray(log.sampled, bool)
    gated = np.asarray(log.gated, bool)
    lp_bits, hp_bits = _resolve_log_bits(log, params, on_missing_bits)
    f_lp = float(sampled.mean())        # fraction of frames LP-converted
    duty = float(gated.mean())          # fraction HP-converted+transmitted
    hdc = _hdc_j(params, precision)
    return EnergyBreakdown(
        sensor=params.rf_frontend_j,
        adc=f_lp * adc_conversion_j(lp_bits, params)
        + duty * adc_conversion_j(hp_bits, params),
        hdc=f_lp * hdc,
        comm=duty * params.comm_j,
        cloud=duty * params.cloud_j,
    )


# ---------------------------------------------------------------------------
# Downstream-backbone cost (the gated cascade's "cloud" term)
# ---------------------------------------------------------------------------

#: Effective edge-accelerator energy per FLOP for the downstream backbone.
#: Grounded on Jetson AGX Orin-class sustained efficiency (the paper's
#: end-to-end comparison platform): ~5 TFLOP/s FP32 useful throughput at
#: ~40 W wall → ~8 pJ/FLOP. A constant, like the other per-component
#: Joules above — the cascade claims are *ratios* (duty × backbone vs
#: always-on backbone), which a shared constant cancels out of.
EDGE_J_PER_FLOP = 8e-12


@dataclass(frozen=True)
class BackboneCost:
    """Measured per-frame cost of the downstream detector/backbone.

    ``flops``/``bytes`` are the backbone step's per-frame operations and
    bytes;
    ``joules = flops * j_per_flop`` is the energy the cascade bills per
    frame the gate lets through (the term that replaces the 3G+cloud
    ``cloud_j`` when the backbone runs on-device next to the gate).
    """
    flops: float
    bytes: float
    joules: float


def cascade_system(log, backbone: BackboneCost,
                   params: EnergyParams | None = None,
                   precision: str = "float32") -> EnergyBreakdown:
    """Per-frame energy of the full gate→backbone cascade (paper §V-E).

    The capture-log account (:func:`from_capture_log`) with the
    gated-path downstream swapped for the *measured* backbone: the
    backbone runs co-located with the gate, so the 3G transmission and
    cloud terms vanish and ``cloud`` becomes
    ``duty × backbone.joules`` — gate duty cycle × backbone cost, the
    paper's system-level arithmetic. Requires a real recorded burst
    depth (``on_missing_bits="error"``): a cascade is by construction a
    closed-loop producer, so ``hp_bits=None`` here is a wiring bug.
    """
    params = params or EnergyParams()
    base = from_capture_log(log, params, precision,
                            on_missing_bits="error")
    duty = float(np.asarray(log.gated, bool).mean())
    return EnergyBreakdown(sensor=base.sensor, adc=base.adc, hdc=base.hdc,
                           comm=0.0, cloud=duty * backbone.joules)


def always_on_backbone(backbone: BackboneCost,
                       params: EnergyParams | None = None
                       ) -> EnergyBreakdown:
    """Per-frame energy of the cascade's baseline: no gate, the
    high-precision ADC converts every frame and the backbone processes
    every frame (duty ≡ 1, no HDC, no transmission — same co-located
    deployment as :func:`cascade_system`, so the two differ only in
    what the gate saves)."""
    params = params or EnergyParams()
    return EnergyBreakdown(sensor=params.rf_frontend_j,
                           adc=params.adc_hp_j, hdc=0.0, comm=0.0,
                           cloud=backbone.joules)


def savings(ours: EnergyBreakdown, base: EnergyBreakdown) -> dict:
    return {
        "total_saving": 1.0 - ours.total / base.total,
        "edge_saving": 1.0 - ours.edge / base.edge,
    }


def quality_loss(tpr: float) -> float:
    """Fraction of object frames the gate drops (paper Table III)."""
    return 1.0 - tpr


# ---------------------------------------------------------------------------
# Calibration against paper Table III
# ---------------------------------------------------------------------------

#: paper Table III @ p_object = 1%: FPR -> (total saving, edge saving, QL)
PAPER_TABLE_III = {
    0.05: (0.921, 0.647, 0.0744),
    0.10: (0.898, 0.606, 0.0493),
    0.20: (0.806, 0.524, 0.0292),
    0.30: (0.713, 0.442, 0.0195),
}


def calibrate(p_object: float = 0.01,
              table: dict | None = None) -> EnergyParams:
    """Least-squares fit (rf_frontend, comm, cloud) to Table III.

    TPR at each operating point is implied by the paper's quality loss
    (QL = 1 - TPR). Keeps ADC/HDC constants at their documented defaults.

    The fit is *bounded* to the physical domain (``method="trf"``,
    ``bounds=(0, inf)``): the constants are Joules, and the earlier
    unconstrained LM solve wrapped in ``abs()`` could silently accept a
    sign-flipped (non-physical) optimum whose folded-back magnitudes no
    longer minimize anything. (Freed from that distortion the fit finds
    a better Table III residual — ~0.020 vs LM's ~0.030 — by riding the
    table's scale degeneracy: savings are energy *ratios*, so the
    optimizer may return large absolute magnitudes. Fine for reproducing
    the paper's saving percentages, which is all this is used for; the
    documented defaults remain the physically-grounded constants.)
    """
    from scipy.optimize import least_squares

    table = table or PAPER_TABLE_III
    base = EnergyParams()

    def residuals(x):
        rf, comm_scale, cloud = x
        p = replace(base, rf_frontend_j=float(rf),
                    comm_j_per_mbit=float(comm_scale), cloud_j=float(cloud))
        res = []
        for fpr, (tot, edge, ql) in table.items():
            tpr = 1.0 - ql
            ours = hypersense(fpr, tpr, p_object, p)
            conv = conventional(p)
            s = savings(ours, conv)
            res += [s["total_saving"] - tot, s["edge_saving"] - edge]
        return res

    x0 = [base.rf_frontend_j, base.comm_j_per_mbit, base.cloud_j]
    sol = least_squares(residuals, x0, method="trf",
                        bounds=(0.0, np.inf))
    rf, comm_scale, cloud = [float(v) for v in sol.x]
    return replace(base, rf_frontend_j=rf, comm_j_per_mbit=comm_scale,
                   cloud_j=cloud)
