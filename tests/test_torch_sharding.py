"""PyTorch port, the sharding rules: ``repro_torch.distributed.sharding``
against ``repro.distributed.sharding``.

The port's rule functions read a mesh's dimension names and sizes alone,
so they take a ``{name: size}`` mapping; the reference's take a
``jax.sharding.AbstractMesh`` of the same shape (no devices needed). Both
must give the same mesh extents, padded extents and specs on every shape
of the reference's matrix and the production mesh, for dims that divide
and that do not: ``hyperdim`` at 1, 5, 8 and 10 tiles, ``sensors`` at 2,
5 and 9 streams. Then the ``use_mesh`` / ``current_mesh`` contract,
including on error.
"""

import itertools

import jax
import pytest

from repro.distributed import sharding as jsh
from repro_torch.distributed import sharding as tsh

jax.config.update("jax_platform_name", "cpu")

SHAPES = {"1x1": (1, 1), "8x1": (8, 1), "4x2": (4, 2), "2x4": (2, 4),
          "1x8": (1, 8), "2x16x16": (2, 16, 16)}


def meshes(name):
    """``(reference AbstractMesh, the port's {name: size})`` of a shape."""
    shape = SHAPES[name]
    names = (("data", "model") if len(shape) == 2
             else ("pod", "data", "model"))
    return (jax.sharding.AbstractMesh(shape, names),
            dict(zip(names, shape)))


def test_rules_are_the_reference_table():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert tsh.PRIORITY_NAMES == jsh.PRIORITY_NAMES


@pytest.mark.parametrize("name", list(SHAPES))
def test_mesh_extent_and_padded_extent(name):
    jm, tm = meshes(name)
    for logical in list(jsh.DEFAULT_RULES) + ["unmapped"]:
        assert tsh.mesh_extent(logical, tm) == jsh.mesh_extent(logical, jm)
        for n in (0, 1, 2, 3, 5, 8, 9, 10, 17, 33):
            assert (tsh.padded_extent(n, logical, tm)
                    == jsh.padded_extent(n, logical, jm)), (logical, n)


@pytest.mark.parametrize("name", list(SHAPES))
def test_fleet_axes_divide_or_replicate(name):
    """The fleet's two logical axes: ``hyperdim`` shards a tile count the
    "model" extent divides and is replicated otherwise (never padded);
    ``sensors`` likewise, while its mesh extent ignores divisibility."""
    jm, tm = meshes(name)
    for n_dt in (1, 5, 8, 10):
        got = tsh.spec_for((n_dt,), ("hyperdim",), tm)
        assert got == tuple(jsh.spec_for((n_dt,), ("hyperdim",), jm))
        model = tm["model"]
        assert got == (("model",) if n_dt % model == 0 else (None,))
    for S in (2, 5, 9):
        for shape, axes in (((S,), ("sensors",)),
                            ((S, 2, 128), ("sensors", None, "hyperdim"))):
            assert (tsh.spec_for(shape, axes, tm)
                    == tuple(jsh.spec_for(shape, axes, jm)))
        _, k = tsh.mesh_extent("sensors", tm)
        assert tsh.padded_extent(S, "sensors", tm) % k == 0


@pytest.mark.parametrize("name", list(SHAPES))
def test_spec_for_matches_the_reference(name):
    """Every pair of logical names on sizes that do and do not divide the
    mesh (priority names first, taken dims skipped)."""
    jm, tm = meshes(name)
    logicals = list(jsh.DEFAULT_RULES) + [None]
    for a, b in itertools.product(logicals, repeat=2):
        for shape in ((16, 32), (6, 8), (2, 5), (512, 3)):
            assert (tsh.spec_for(shape, (a, b), tm)
                    == tuple(jsh.spec_for(shape, (a, b), jm))), (a, b, shape)
    assert tsh.spec_for((4, 4), ("embed", "mlp"), tm, rules={
        "embed": "model", "mlp": None}) == tuple(jsh.spec_for(
            (4, 4), ("embed", "mlp"), jm, rules={"embed": "model",
                                                  "mlp": None}))


def test_without_a_mesh_everything_is_replicated():
    assert tsh.current_mesh() is None
    assert tsh.mesh_extent("sensors") == ((), 1)
    assert tsh.padded_extent(5, "sensors") == 5
    assert tsh.padded_extent(0, "sensors") == 1
    assert tsh.spec_for((8, 4), ("sensors", "hyperdim")) == (None, None)
    with pytest.raises(ValueError):
        tsh.spec_for((8,), ("sensors", "hyperdim"))


def test_use_mesh_context():
    """``current_mesh()`` is None outside, the mesh inside (the innermost
    when nested), and the previous one again after the scope, also when
    the scope raises; the rules merge over the default table."""
    outer, inner = {"data": 2, "model": 1}, {"data": 1, "model": 4}
    assert tsh.current_mesh() is None
    with tsh.use_mesh(outer) as m:
        assert m is outer and tsh.current_mesh() is outer
        assert tsh.mesh_extent("sensors") == (("data",), 2)
        with tsh.use_mesh(inner, rules={"sensors": ("model",)}):
            assert tsh.current_mesh() is inner
            assert tsh.current_rules()["sensors"] == ("model",)
            assert tsh.current_rules()["hyperdim"] == ("model",)
            assert tsh.mesh_extent("sensors") == (("model",), 4)
        assert tsh.current_mesh() is outer
        assert tsh.current_rules() == tsh.DEFAULT_RULES
    assert tsh.current_mesh() is None


def test_use_mesh_restores_after_an_error():
    mesh = {"data": 2, "model": 2}
    with tsh.use_mesh(mesh):
        with pytest.raises(RuntimeError):
            with tsh.use_mesh({"data": 4, "model": 1}):
                raise RuntimeError("inside")
        assert tsh.current_mesh() is mesh
    with pytest.raises(KeyError):
        with tsh.use_mesh(mesh):
            raise KeyError("x")
    assert tsh.current_mesh() is None
    assert tsh.current_rules() == tsh.DEFAULT_RULES


def test_mesh_shape_needs_named_dims():
    class Unnamed:
        mesh_dim_names = None
    with pytest.raises(ValueError):
        tsh.mesh_shape(Unnamed())
    with pytest.raises(ValueError):
        tsh.axis_group(Unnamed(), ("pod", "data"))


@pytest.mark.parametrize("arch", ["full", "smoke"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_param_specs_match_the_reference_param_shardings(name, arch):
    """``Model.param_specs`` (the blocks the sharded detector keeps) is
    the reference's ``Model.param_shardings`` leaf by leaf, on the
    ``hubert-xlarge`` config and its smoke config."""
    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro_torch import configs
    from repro_torch.models import common, lm
    jm, tm = meshes(name)
    get = "get_config" if arch == "full" else "get_smoke"
    model = lm.Model(getattr(configs, get)("hubert-xlarge"))
    decls = common.leaves(model.spec())
    jtree = jlm.build(getattr(jconfigs, get)("hubert-xlarge")
                      ).param_shardings(jm)
    shardings = jax.tree.leaves(jtree)
    assert len(shardings) == len(decls) == 13
    want = [tuple(s.spec) + (None,) * (len(p.shape) - len(s.spec))
            for s, p in zip(shardings, decls)]
    got = []
    common.tree_map(got.append, model.param_specs(tm),
                    lambda x: isinstance(x, tuple))
    assert got == want
    if "model" in tm and tm["model"] > 1:
        assert any("model" in spec for spec in got)
