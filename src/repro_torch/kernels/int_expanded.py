"""The expanded-slab integer scorer on PyTorch: the retired layout, kept as
the yardstick of the live int scorer.

Twin of ``benchmarks/int_datapath.py``'s ``_expand_slabs`` and
``_expanded_scores`` (the Pallas ``_expanded_kernel``): the int scorer as it
was before the live kernel's layout, reading a pre-shifted ``(n_dt, h*W,
TD)`` int8 operand whose row ``(r, i)`` is ``slabs_q[dt, r, i : i + TD]``.
The operand sits in device memory and grows linearly in the frame width
``W``; the live kernel's block does not. The race of
``chip_smoke.py``'s int-datapath phase measures that difference, so the
kernel keeps the layout.

:func:`expanded_scores` is the wrapper: a CUDA tensor launches
``csrc/int_expanded.cu`` (or raises); a CPU tensor runs
:func:`expanded_scores_plain`. :func:`expanded_window_acc` exposes the exact
int32 window sums, for bitwise checks against
``sliding_scores_int.int_window_acc``. Like the reference's twin it takes
single-model class tiles and the RFF nonlinearity only, and no packed int4
codes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import sliding_scores as _ss
from repro_torch.kernels import sliding_scores_int as _ssi

#: calls of the C entry (three kernel launches each: window norms, the
#: scorer, the fold) made by :func:`expanded_scores`
LAUNCHES = 0

#: hypervector columns per CUDA block (``kBN``): the live int kernel's
#: partition of a D-tile into the partials that ``fold_epilogue`` folds
COL_TILE = 128

#: codes the kernel reads as they are (``CodesLayout`` in the CUDA source);
#: other integer codes are widened to int32 at the kernel boundary
_LAYOUTS = {torch.uint8: 0, torch.int32: 2, torch.uint16: 3}


def expand_slabs(geom: _ssi.IntScoreGeometry, W: int) -> torch.Tensor:
    """The ``(n_dt, h*W, TD)`` int8 operand from the compact slabs, on the
    geometry's device: row ``r*W + i`` is ``slabs_q[:, r, i : i + TD]``
    (the compact slabs are ``TD + W - 1`` long, so ``W`` windows fit),
    bit-identical to the layout the int scorer retired."""
    n_dt, h, L = geom.slabs_q.shape
    td = geom.block_d
    if L != td + W - 1:
        raise ValueError(f"slabs of length {L} do not fit {W}-wide frames "
                         f"at TD={td}")
    rows = geom.slabs_q.unfold(-1, td, 1)                  # (n_dt, h, W, td)
    return rows.reshape(n_dt, h * W, td).contiguous()


def expanded_bytes(h: int, W: int, D: int, block_d: int = 512) -> int:
    """Bytes of the expanded operand for windows ``h`` rows high over
    ``W``-wide frames at dimensionality ``D``: ``h * W * D`` (the geometry
    takes ``TD = block_d`` when it divides ``D``, else one ``D``-wide tile,
    and every tile holds ``h * W`` rows)."""
    td = block_d if D % block_d == 0 else D
    return (D // td) * h * W * td


def _geometry(codes: torch.Tensor, slab_mat: torch.Tensor,
              geom: _ssi.IntScoreGeometry, h: int, w: int, stride: int):
    """Check the operands; returns ``(N, H, W, my, mx, n_dt, td)``."""
    _ss._check_device(codes)
    _ssi._check_codes_integer(codes)
    if codes.ndim != 3:
        raise ValueError(f"codes must be (N, H, W), got {tuple(codes.shape)}")
    N, H, W = codes.shape
    my = (H - h) // stride + 1
    mx = (W - w) // stride + 1
    n_dt = geom.slabs_q.shape[0]
    td = geom.block_d
    _ssi._check_geometry(geom, h, w, stride, W, mx)
    if (tuple(slab_mat.shape) != (n_dt, h * W, td)
            or slab_mat.dtype != torch.int8):
        raise ValueError(f"expanded operand {tuple(slab_mat.shape)} "
                         f"{slab_mat.dtype} is not expand_slabs(geom, {W}): "
                         f"({n_dt}, {h * W}, {td}) int8")
    if slab_mat.device != codes.device:
        raise ValueError(f"codes on {codes.device}, operand on "
                         f"{slab_mat.device}")
    return N, H, W, my, mx, n_dt, td


def _check_tiles(tiles: _ssi.IntScoreTiles, nonlinearity: str) -> None:
    if tiles.cpos_t.ndim != 3:
        raise ValueError("the expanded-slab scorer takes single-model class "
                         "tiles (n_dt, mx, TD), as the reference's twin "
                         "does; per-stream tiles go to the live scorer")
    if nonlinearity != "rff":
        raise ValueError(f"the expanded-slab scorer applies RFF only, as the "
                         f"reference's twin does; got {nonlinearity!r}")


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _window_acc_plain(codes: torch.Tensor, slab_mat: torch.Tensor, *,
                      h: int, w: int, stride: int) -> torch.Tensor:
    """Exact ``(N, my, mx, n_dt*TD)`` int32 window sums from the expanded
    operand: per base row ``r``, the band's code row, masked per window by
    the ``(mx, W)`` indicator, times the operand's ``(W, TD)`` rows of
    ``r``. The products run in float64, where every partial sum of these
    integers is exact, so the order of summation does not matter."""
    N, H, W = codes.shape
    my = (H - h) // stride + 1
    mx = (W - w) // stride + 1
    n_dt, _, td = slab_mat.shape
    dev = codes.device
    i = torch.arange(W, device=dev)[None, :]
    kx = torch.arange(mx, device=dev)[:, None] * stride
    mask = ((i >= kx) & (i < kx + w)).to(torch.float64)         # (mx, W)
    ky = torch.arange(my, device=dev) * stride
    x = codes.to(torch.float64)
    E = slab_mat.reshape(n_dt, h, W, td).to(torch.float64)
    acc = torch.zeros((N, my, mx, n_dt * td), dtype=torch.float64,
                      device=dev)
    for r in range(h):
        S = E[:, r].permute(1, 0, 2).reshape(W, n_dt * td)
        acc = acc + (x[:, ky + r, None, :] * mask) @ S
    return acc.to(torch.int32)


def expanded_scores_plain(codes: torch.Tensor, slab_mat: torch.Tensor,
                          tiles: _ssi.IntScoreTiles, *, h: int, w: int,
                          stride: int, nonlinearity: str = "rff"
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: integer codes ``(N, H, W)`` and
    the expanded operand -> ``(N, my, mx)`` scores. Exact int32 window
    sums, then the live int scorer's plain float epilogue."""
    N = _geometry(codes, slab_mat, tiles.geom, h, w, stride)[0]
    _check_tiles(tiles, nonlinearity)
    acc = _window_acc_plain(codes, slab_mat, h=h, w=w, stride=stride)
    return _ssi.scores_from_window_acc(acc, codes, tiles, h=h, w=w,
                                       stride=stride, nonlinearity="rff",
                                       per_stream=False, C=N)


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

def _launch(codes: torch.Tensor, slab_mat: torch.Tensor,
            tiles: _ssi.IntScoreTiles, *, h: int, w: int, stride: int,
            acc_out: torch.Tensor | None = None) -> torch.Tensor:
    """One call of the C entry: window norms, the scorer, the fold."""
    geom = tiles.geom
    N, H, W, my, mx, n_dt, td = _geometry(codes, slab_mat, geom, h, w,
                                          stride)
    if codes.dtype not in _LAYOUTS:  # widened at the kernel boundary only
        codes = codes.to(torch.int32)
    layout = _LAYOUTS[codes.dtype]
    lib = _build.load("int_expanded")
    smem = lib.int_expanded_smem_bytes(w, stride)
    if smem > _ss.SMEM_LIMIT_BYTES:
        raise ValueError(f"the expanded-slab block needs {smem} B of shared "
                         f"memory for {w}-wide windows at stride {stride}, "
                         f"over the card's {_ss.SMEM_LIMIT_BYTES}")
    dev = codes.device
    codes = codes.contiguous()
    cpos_norm, cneg_norm = _ss._flat_norms(tiles)
    n_ct = n_dt * -(-td // COL_TILE)
    norms = torch.empty((N, my, mx), device=dev)
    partials = torch.empty((n_ct, N * my * mx, 3), device=dev)
    out = torch.empty((N, my, mx), device=dev)
    args = (codes, slab_mat.contiguous(), geom.bias_t,
            tiles.cpos_t.contiguous(), tiles.cneg_t.contiguous(),
            geom.slab_scale, norms, cpos_norm, cneg_norm, partials, out)
    err = lib.int_expanded(
        *(a.data_ptr() for a in args),
        None if acc_out is None else acc_out.data_ptr(),
        N, H, W, h, w, stride, td, n_dt, layout, _build.stream_ptr())
    _build.check(err, "int_expanded")
    return out


def expanded_scores(codes: torch.Tensor, slab_mat: torch.Tensor,
                    tiles: _ssi.IntScoreTiles, *, h: int, w: int,
                    stride: int, nonlinearity: str = "rff") -> torch.Tensor:
    """``(N, H, W)`` integer ADC codes and the expanded operand
    (:func:`expand_slabs`) -> ``(N, my, mx)`` score maps in one call of the
    C entry, which launches its three kernels; :data:`LAUNCHES` counts the
    calls.

    A CUDA tensor launches ``csrc/int_expanded.cu`` (or raises); a CPU
    tensor runs :func:`expanded_scores_plain`. Single-model tiles and RFF
    only, as the reference's twin.
    """
    global LAUNCHES
    _ss._check_device(codes)
    if codes.device.type == "cpu":
        return expanded_scores_plain(codes, slab_mat, tiles, h=h, w=w,
                                     stride=stride,
                                     nonlinearity=nonlinearity)
    _check_tiles(tiles, nonlinearity)
    out = _launch(codes, slab_mat, tiles, h=h, w=w, stride=stride)
    LAUNCHES += 1
    return out


def expanded_window_acc(codes: torch.Tensor, slab_mat: torch.Tensor,
                        geom: _ssi.IntScoreGeometry, *, h: int, w: int,
                        stride: int) -> torch.Tensor:
    """The exact int32 window sums ``(N, my, n_dt, mx, TD)``, the layout of
    ``sliding_scores_int.int_window_acc``.

    A CPU tensor runs the plain version; a CUDA tensor runs the kernel with
    its accumulator output switched on (class tiles of zeros). A check, not
    part of scoring: it does not count in :data:`LAUNCHES`.
    """
    N, H, W, my, mx, n_dt, td = _geometry(codes, slab_mat, geom, h, w,
                                          stride)
    if codes.device.type == "cpu":
        acc = _window_acc_plain(codes, slab_mat, h=h, w=w, stride=stride)
        return acc.reshape(N, my, mx, n_dt, td).permute(0, 1, 3, 2, 4)
    dev = codes.device
    zeros = torch.zeros(geom.bias_t.shape, dtype=torch.int8, device=dev)
    ones = torch.ones((), device=dev)
    tiles = _ssi.IntScoreTiles(geom=geom, cpos_t=zeros, cneg_t=zeros,
                               cpos_norm=ones, cneg_norm=ones)
    acc = torch.empty((N, my, n_dt, mx, td), dtype=torch.int32, device=dev)
    _launch(codes, slab_mat, tiles, h=h, w=w, stride=stride, acc_out=acc)
    return acc
