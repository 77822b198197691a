"""PyTorch port, the sharded train and prefill steps on the CPU:
``steps.build_cell(cfg, shape, mesh)`` over ``gloo`` worlds of 1, 2 and
4 ranks, each spawned once per module
(``tests/_torch_train_mesh_worker.py``), every rank running each mesh
shape of its world: (1, 1); (1, 2), (2, 1); (2, 2), (1, 4), (4, 1) and a
("pod", "data", "model") (2, 1, 2). The cases: the smoke hubert-xlarge
(float32, remat "full" in bf16, the chunked vocab-8192 loss); the smoke
internlm2-1.8b on (1, 4), whose 4 query heads split while its 2 kv heads
stay whole (each rank one query head of a group of two); the smoke
olmo-1b (parameter-free norms, MHA) and internvl2-76b (the image prefix)
on (2, 2) and (4, 1); the smoke zamba2-1.2b (the hybrid, by SSM heads:
its in_proj and convolution blocks, which are not one rank's heads,
gathered and cut) on (1, 2), (2, 2) and (1, 4), and at SSM state 7 on
(1, 4), where those blocks stay whole; the smoke xlstm-350m (its 2 heads
split on (1, 2) and (2, 2), whole on (1, 4) with its inner dims split
there, as the production meshes' "model" of 16 leaves xlstm-350m's 4), in
float32 and in bf16 under remat "full"; each also on (1, 1). The hybrid's
and the xLSTM's weights are drawn at ``TW.HYBRID_WEIGHT_STD`` (0.02),
where the random models are well conditioned.

Every rank cuts its blocks from one whole mid-run state (numpy arrays:
weights at ``WEIGHT_STD``, as in ``tests/test_torch_cells.py``, moments
drawn, the step counter at ``MID_RUN_STEP``, past the warmup) and gathers
its results back whole. Held: the sharded step (loss, gradients, the
parameters and both moments after AdamW) against the unsharded port
step and the reference's jitted ``build_train_cell`` step; the sharded
prefill's logits against ``Model.forward`` and the reference's prefill;
every replicated value bitwise the same on every rank, and two steps
from one state bitwise the same; the (1, 1) mesh bitwise the unsharded
step; the batch's layout on each mesh (on (4, 1) the batch of 2 runs
whole on every data rank, and the result is still the batch's);
the vocab-parallel token embedding bitwise the unsharded one on every
mesh and rank, in float32 and bf16; the sharded detector's forward
bitwise through the differentiable collectives and through their
forward arithmetic alone.

The decode cell (``DECODE`` of the worker) in the same worlds: the smoke
internlm2-1.8b with its 2 kv heads split over "model" on (1, 2) and
(2, 2) and its cache split along the sequence ("cache_seq") on (1, 4),
and again with "act_kv_heads" unmapped (the cache along the sequence on
every mesh, the weights' kv heads split on (1, 2)); the smoke olmo-1b on
(2, 2) and (4, 1); the smoke zamba2 (its float32 SSM states by heads,
its bf16 convolution buffers whole, its two shared-block caches by kv
heads) on (1, 2), (2, 2) and (1, 4); the smoke xlstm-350m (its
per-block states by heads, whole on (1, 4), its bf16 convolution buffers
whole) on the same meshes; each on (1, 1). One step from a half-filled
bf16 cache (numpy, the same for every side; the hybrid's float32 SSM
states and bf16 buffers N(0, 1); the xLSTM's a state reached by decoding
six tokens from zeros), twice: the next tokens
equal to the unsharded port's and the reference's jitted
``decode_step``'s, the logits within ``GRAD_RTOL`` of their largest
|logit|, the cache (and the hybrid's buffers) after the step within one
bf16 ulp of both (the new k and v rounded from float32 sums in another
order), the hybrid's SSM states and the xLSTM's float32 states within
``GRAD_RTOL``; every rank
bitwise the same, run to run, and (1, 1) bitwise the unsharded step;
the cache's spec the split named.

Tolerances, float32: the loss within ``LOSS_RTOL``, each gradient and
each leaf after AdamW within ``GRAD_RTOL`` of its largest |entry| (the
packages and the meshes sum in other orders). bf16 (``BF16_TOL``): the
loss within 1e-2 relative, gradients and moments within 5% of each
leaf's largest |entry| (``chip_smoke.py``'s card-vs-CPU bounds); the
parameters after AdamW are not held across layouts in bf16: AdamW
divides each element by the root of its second moment, so a bf16
gradient's rounding comes back magnified where that moment is small
(they are held bitwise across ranks and run to run).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
import _torch_train_mesh_worker as TW
from _torch_parity import within_one_bf16_ulp
from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro.train import optim as joptim
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import attention, common, lm, ssm, xlstm
from repro_torch.train import optim

jax.config.update("jax_platform_name", "cpu")

WEIGHT_STD = 0.2
MID_RUN_STEP = 2400
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
BF16_TOL = {"loss": 1e-2, "grads": 5e-2, "mu": 5e-2, "nu": 5e-2}
#: the mixture of experts against the reference, float32: each leaf within
#: 1e-4 of its largest |entry| (``chip_smoke.py``'s CELLS_TOL gradient
#: bound). The smoke grok-1 with 3 experts is the worst conditioned case:
#: both packages' embedding gradients lie 6e-6 and 7.5e-6 off a float64
#: run of the port, 1.3e-5 apart; against the unsharded port every
#: layout is held within GRAD_RTOL
MOE_REF_RTOL = 1e-4
SPAWN_TIMEOUT = 240.0
#: the batch's spec (``act_batch``) on each mesh: (4, 1) does not split
#: a batch of 2, nor (2, 2) a batch of 1; (2, 1, 2) splits it over the
#: two-dim ("pod", "data") group
BATCH_SPEC = {"1x1": "data", "1x2": "data", "2x1": "data", "2x2": "data",
              "1x4": "data", "4x1": None, "2x1x2": ("pod", "data")}
RUNS = [(TW.mesh_key(m), c) for ms in TW.WORLDS.values() for m in ms
        for c in TW.TRAIN_CASES if m in TW.CASE_MESHES.get(c, [m])]
DECODE_RUNS = [(TW.mesh_key(m), c) for ms in TW.WORLDS.values() for m in ms
               for c in TW.DECODE if m in TW.CASE_MESHES[c]]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The spawned ranks run single-threaded; so does the unsharded side
    (and the files after this one get their thread count back)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def np_params(spec, seed, std=WEIGHT_STD):
    rng = np.random.default_rng(seed)

    def one(p):
        x = rng.standard_normal(p.shape).astype(np.float32)
        if p.init == "ones":
            return 1 + 0.1 * x
        if p.init == "zeros":
            return 0.1 * x
        return std * x
    return common.tree_map(one, spec, lambda x: isinstance(x, common.P))


def weight_std(case) -> float:
    return (TW.HYBRID_WEIGHT_STD if case in TW.HYBRID_CASES + TW.XLSTM_CASES
            else WEIGHT_STD)


def case_payload(case, seed):
    """The whole mid-run state and batch of ``case``, as numpy."""
    cfg = TW.config(case)
    arrays = np_params(lm.Model(cfg).spec(), seed, weight_std(case))
    rng = np.random.default_rng(seed + 1)
    b, s = TW.CASES[case][1]
    state = optim.AdamWState(
        step=np.int32(MID_RUN_STEP),
        mu=common.tree_map(lambda a: 0.01 * rng.standard_normal(
            a.shape).astype(np.float32), arrays),
        nu=common.tree_map(lambda a: 1e-4 * rng.random(a.shape).astype(
            np.float32), arrays))
    labels = rng.integers(-1, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.embeds_in:
        return dict(params=arrays, state=state, labels=labels,
                    embeds=rng.standard_normal((b, s, cfg.d_model)).astype(
                        np.float32))
    return dict(params=arrays, state=state, labels=labels,
                tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
                embeds=rng.standard_normal(
                    (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
                if cfg.family == "vlm" else None)


def reference(case, p):
    """The reference's jitted train step from the same state (loss,
    parameters, moments), its gradients (float32 cases) and its prefill
    logits, as numpy leaves."""
    jcfg = jconfigs.get_smoke(TW.arch(case)).replace(**TW.CASES[case][0])
    mesh = jax.sharding.AbstractMesh((1, 1), ("data", "model"))
    params = jax.tree.map(jnp.asarray, p["params"])
    state = joptim.AdamWState(
        step=jnp.int32(MID_RUN_STEP),
        mu=jax.tree.map(jnp.asarray, p["state"].mu),
        nu=jax.tree.map(jnp.asarray, p["state"].nu))
    batch = jlm.Batch(*(None if p.get(k) is None else jnp.asarray(p[k])
                        for k in ("tokens", "labels", "embeds")))
    shape = jconfigs.SMOKE_SHAPE
    new_p, new_s, loss = jax.jit(jsteps.build_train_cell(
        jcfg, shape, mesh).step_fn)(params, state, batch)
    logits = jax.jit(jsteps.build_prefill_cell(jcfg, shape, mesh).step_fn)(
        params, batch)

    def leaves(t):
        return [np.asarray(x, np.float32) for x in jax.tree.leaves(t)]
    out = dict(loss=float(loss), params=leaves(new_p), mu=leaves(new_s.mu),
               nu=leaves(new_s.nu), step=int(new_s.step),
               logits=np.asarray(logits, np.float32))
    if jcfg.compute_dtype == "float32":
        model = jlm.build(jcfg)
        _, grads = jax.jit(jax.value_and_grad(
            lambda q: model.loss(q, batch)))(params)
        out["grads"] = leaves(grads)
    return out


def decode_payload(case, seed):
    """The decode case's parameters, its half-filled cache (bf16 values,
    positions from the index on zero; the hybrid's besides: float32 SSM
    states and bf16 convolution buffers, N(0, 1)) and its tokens, as
    numpy."""
    cfg = TW.config(case)
    model = lm.Model(cfg)
    arrays = np_params(model.spec(), seed, weight_std(case))
    rng = np.random.default_rng(seed + 1)
    b, s = TW.CASES[case][1]
    index = TW.DECODE[case][1]
    spec = model.decode_state_spec(b, s)

    def bf16(x):
        return torch.from_numpy(x).to(torch.bfloat16).to(
            torch.float32).numpy()

    def normal(t):
        return rng.standard_normal(tuple(t.shape)).astype(np.float32)

    def cache(t):
        x = normal(t)
        x[:, :, index:] = 0
        return bf16(x)
    if cfg.family == "ssm":
        state = reached_xlstm_state(model, arrays, b, rng)
    elif cfg.family == "hybrid":
        state = {"mamba": ssm.SSMState(normal(spec["mamba"].ssm),
                                       bf16(normal(spec["mamba"].conv))),
                 "attn": attention.KVCache(*map(cache, spec["attn"]))}
    else:
        state = attention.KVCache(*map(cache, spec))
    return dict(params=arrays, cache=state,
                tokens=rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32))


def reached_xlstm_state(model, arrays, b, rng, n_tokens=6):
    """An xLSTM state the recurrence can reach: ``n_tokens`` random tokens
    decoded from zeros by the unsharded port (float32 convolution
    buffers, rounded to bf16 after), as numpy per-block states."""
    params = lm_params_from_arrays(arrays, cfg=model.cfg, device="cpu")
    st = lm.map_state(lambda t: t.to(torch.float32),
                      model.init_decode_state(b, 1, device="cpu"))
    tokens = torch.from_numpy(rng.integers(
        0, model.cfg.vocab, (b, n_tokens)).astype(np.int32))
    for t in range(n_tokens):
        model.decode_step(params, st, lm.DecodeBatch(
            tokens[:, t:t + 1], torch.tensor(t, dtype=torch.int32)))

    def arrays_of(s):
        leaves = [t.numpy().copy() for t in s]
        if isinstance(s, xlstm.MLSTMState):
            leaves[3] = torch.from_numpy(leaves[3]).to(torch.bfloat16).to(
                torch.float32).numpy()
        return type(s)(*leaves)
    return [arrays_of(s) for s in st]


def reference_decode(case, p):
    """The reference's jitted ``decode_step`` from the same state: the
    next tokens, the logits and the state after the step, as numpy."""
    jcfg = jconfigs.get_smoke(TW.arch(case)).replace(**TW.CASES[case][0])

    def cache(c):
        return jattention.KVCache(*(jnp.asarray(a, jnp.bfloat16) for a in c))
    c = p["cache"]
    if isinstance(c, list):
        state = [jxlstm.MLSTMState(*map(jnp.asarray, s[:3]),
                                   jnp.asarray(s.conv, jnp.bfloat16))
                 if isinstance(s, xlstm.MLSTMState)
                 else jxlstm.SLSTMState(*map(jnp.asarray, s)) for s in c]
    else:
        state = cache(c) if not isinstance(c, dict) else {
            "mamba": jssm.SSMState(jnp.asarray(c["mamba"].ssm),
                                   jnp.asarray(c["mamba"].conv,
                                               jnp.bfloat16)),
            "attn": cache(c["attn"])}
    logits, state = jax.jit(jlm.build(jcfg).decode_step)(
        jax.tree.map(jnp.asarray, p["params"]), state,
        jlm.DecodeBatch(jnp.asarray(p["tokens"]),
                        jnp.int32(TW.DECODE[case][1])))
    logits = np.asarray(logits, np.float32)
    out = dict(tokens=logits[:, -1].argmax(-1), logits=logits)
    if isinstance(state, list):
        out.update({f"{i}.{name}": np.asarray(t, np.float32)
                    for i, st in enumerate(state)
                    for name, t in zip(st._fields, st)})
        return out
    kv = state["attn"] if isinstance(state, dict) else state
    out.update(k=np.asarray(kv.k, np.float32), v=np.asarray(kv.v, np.float32))
    if isinstance(state, dict):
        out.update(ssm=np.asarray(state["mamba"].ssm, np.float32),
                   conv=np.asarray(state["mamba"].conv, np.float32))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case unsharded (``"ref"``) and through the reference
    (``"jax"``), and every world's ranks (``{mesh key: {(kind, name):
    result}}`` a rank)."""
    payload = {c: case_payload(c, 20 + 5 * i)
               for i, c in enumerate(TW.TRAIN_CASES)}
    payload.update({c: decode_payload(c, 60 + 5 * i)
                    for i, c in enumerate(TW.DECODE)})
    payload["frames"] = np.random.default_rng(6).normal(
        size=(TW.DETECT_BATCH, *TW.HW)).astype(np.float32)
    out = {"ref": {c: TW.run_case(c, payload, None)
                   for c in TW.TRAIN_CASES},
           "jax": {c: reference(c, payload[c]) for c in TW.TRAIN_CASES}}
    out["ref"].update({c: TW.run_decode(c, payload, None)
                       for c in TW.DECODE})
    out["jax"].update({c: reference_decode(c, payload[c])
                       for c in TW.DECODE})
    work = ([("case", c, ()) for c in TW.TRAIN_CASES]
            + [("decode", c, ()) for c in TW.DECODE]
            + [("embed", c, ()) for c in TW.CASE_ARCH]
            + [("cascade", "cascade", ())])
    # the worlds run at once, each in its own processes
    with ThreadPoolExecutor(len(TW.WORLDS)) as pool:
        futures = [pool.submit(
            W.spawn, (1, world), work, payload,
            str(tmp_path_factory.mktemp(f"train{world}")),
            timeout=SPAWN_TIMEOUT, target=TW._rank_main)
            for world in TW.WORLDS]
        for fut in futures:
            ranks = fut.result()
            for key in ranks[0]:
                out[key] = [r[key] for r in ranks]
    return out


def rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def hold(got, want, case, keys=("grads", "params", "mu", "nu"),
         grad_rtol=GRAD_RTOL):
    """``got`` against ``want`` within the case's tolerances (float32:
    ``grad_rtol`` for each leaf)."""
    bf16 = TW.config(case).compute_dtype == "bfloat16"
    tol = BF16_TOL["loss"] if bf16 else LOSS_RTOL
    assert abs(got["loss"] - want["loss"]) <= tol * abs(want["loss"])
    for key in keys:
        if key not in want or (bf16 and key == "params"):
            continue
        assert len(got[key]) == len(want[key])
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            assert g.shape == w.shape, (key, i)
            err = rel(g, w)
            assert err <= (BF16_TOL[key] if bf16 else grad_rtol), \
                (key, i, err)


@pytest.mark.parametrize("mesh,case", RUNS)
def test_train_step_against_the_unsharded_port_and_the_reference(
        runs, mesh, case):
    """Rank 0's gathered step (every rank's is the same, below)."""
    got = runs[mesh][0][("case", case)]
    assert got["step"] == MID_RUN_STEP + 1
    assert got["step_loss"] == got["loss"]
    hold(got, runs["ref"][case], case)
    want = runs["jax"][case]
    assert want["step"] == got["step"]
    bf16 = TW.config(case).compute_dtype == "bfloat16"
    hold(got, want, case, keys=() if bf16 else (
        "grads", "params", "mu", "nu"),
        grad_rtol=MOE_REF_RTOL if case in TW.MOE_CASES else GRAD_RTOL)


@pytest.mark.parametrize("mesh,case", RUNS)
def test_replicated_values_bitwise_on_every_rank(runs, mesh, case):
    """The loss, the gathered gradients, parameters and moments and the
    gathered prefill logits: the same bits on every rank; and two steps
    from one state the same bits."""
    first = runs[mesh][0][("case", case)]
    for rank, got in enumerate(runs[mesh]):
        got = got[("case", case)]
        assert got["run_to_run"], rank
        assert got["loss"] == first["loss"], rank
        np.testing.assert_array_equal(got["logits"], first["logits"])
        for key in ("grads", "params", "mu", "nu"):
            for g, w in zip(got[key], first[key], strict=True):
                np.testing.assert_array_equal(g, w, err_msg=f"{rank} {key}")


@pytest.mark.parametrize("case", TW.TRAIN_CASES)
def test_one_rank_mesh_is_bitwise_the_unsharded_step(runs, case):
    got, want = runs["1x1"][0][("case", case)], runs["ref"][case]
    assert got["loss"] == want["loss"] and got["step"] == want["step"]
    np.testing.assert_array_equal(got["logits"], want["logits"])
    for key in ("grads", "params", "mu", "nu"):
        for g, w in zip(got[key], want[key], strict=True):
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("mesh,case", RUNS)
def test_prefill_against_forward_and_the_reference(runs, mesh, case):
    """The gathered logits against the unsharded ``Model.forward`` and the
    reference's prefill: within GRAD_RTOL of the largest |logit| in
    float32, 5% in bf16."""
    got = runs[mesh][0][("case", case)]["logits"]
    tol = BF16_TOL["grads"] if TW.config(case).compute_dtype == \
        "bfloat16" else GRAD_RTOL
    for want in (runs["ref"][case]["logits"], runs["jax"][case]["logits"]):
        assert got.shape == want.shape
        assert rel(got, want) <= tol


@pytest.mark.parametrize("mesh,case", RUNS)
def test_the_batch_layout(runs, mesh, case):
    """The batch's spec on each mesh: a batch the data dims do not split
    runs whole on each of their ranks (the loss folds it once a rank over
    the batch's group, so nothing comes back scaled: the step is held
    above)."""
    want = BATCH_SPEC[mesh] if TW.CASES[case][1][0] == 2 else \
        {"2x2": None}.get(mesh, "data")
    assert runs[mesh][0][("case", case)]["batch_spec"] == (want, None)


MESH_KEYS = [TW.mesh_key(m) for ms in TW.WORLDS.values() for m in ms]


@pytest.mark.parametrize("mesh", MESH_KEYS)
@pytest.mark.parametrize("case", list(TW.CASE_ARCH))
def test_the_sharded_embedding_is_bitwise_the_unsharded_one(runs, mesh,
                                                            case):
    """The vocab-parallel lookup on every mesh, float32 and bf16: bitwise
    the unsharded one on every rank (one nonzero row a token, folded)."""
    for got in runs[mesh]:
        for dt, (same, rows) in got[("embed", case)].items():
            assert same, (dt, rows.shape)


@pytest.mark.parametrize("mesh", MESH_KEYS)
def test_the_sharded_cascade_keeps_its_bits(runs, mesh):
    """The detector's sharded forward through the collectives autograd
    differentiates is bitwise their forward arithmetic alone."""
    for got in runs[mesh]:
        got = got[("cascade", "cascade")]
        np.testing.assert_array_equal(got["autograd"], got["plain"])


#: the cache's spec (its batch, sequence and kv-head entries) each decode
#: case takes on each mesh
DECODE_SPEC = {
    ("internlm2-decode", "1x1"): ("data", None, "model"),
    ("internlm2-decode", "1x2"): ("data", None, "model"),
    ("internlm2-decode", "2x2"): ("data", None, "model"),
    ("internlm2-decode", "1x4"): ("data", "model", None),
    ("internlm2-seq", "1x1"): ("data", "model", None),
    ("internlm2-seq", "1x2"): ("data", "model", None),
    ("internlm2-seq", "1x4"): ("data", "model", None),
    ("olmo-decode", "1x1"): ("data", None, "model"),
    ("olmo-decode", "2x2"): ("data", None, "model"),
    ("olmo-decode", "4x1"): (None, None, "model"),
    ("qwen3-moe-decode", "1x1"): ("data", None, "model"),
    ("qwen3-moe-decode", "1x2"): ("data", None, "model"),
    ("qwen3-moe-decode", "2x1"): ("data", None, "model"),
    ("qwen3-moe-decode", "2x2"): ("data", None, "model"),
    ("zamba2-decode", "1x1"): ("data", None, "model"),
    ("zamba2-decode", "1x2"): ("data", None, "model"),
    ("zamba2-decode", "2x2"): ("data", None, "model"),
    ("zamba2-decode", "1x4"): ("data", None, "model"),
}
#: the state keys each decode case holds: the caches' k and v, and the
#: hybrid's SSM states and convolution buffers
STATE_KEYS = {c: ("k", "v", "ssm", "conv") if c in TW.HYBRID_CASES
              else ("k", "v") for c in TW.DECODE}
STATE_KEYS["xlstm-decode"] = tuple(
    f"{i}.{name}" for i, st in enumerate(lm.Model(TW.config(
        "xlstm-decode")).decode_state_spec(1, 1)) for name in st._fields)
#: the mLSTM's C spec (batch, heads, dh, dh) on each mesh: the 2 heads
#: split over "model" on (1, 2) and (2, 2), whole on (1, 4)
XLSTM_C_SPEC = {"1x1": ("data", "model", None, None),
                "1x2": ("data", "model", None, None),
                "2x2": ("data", "model", None, None),
                "1x4": ("data", None, None, None)}


def float32_state(key: str) -> bool:
    """The hybrid's SSM states and the xLSTM's leaves but its convolution
    buffers are float32; the other state leaves bf16."""
    return key == "ssm" or ("." in key and not key.endswith(".conv"))


@pytest.mark.parametrize("mesh,case", DECODE_RUNS)
def test_decode_against_the_unsharded_port_and_the_reference(runs, mesh,
                                                             case):
    """Rank 0's gathered decode step: the next tokens equal, the logits
    within GRAD_RTOL of the largest |logit|, the caches and the hybrid's
    and the xLSTM's convolution buffers within one bf16 ulp, their
    float32 states within GRAD_RTOL of their largest |entry|, against
    the unsharded port and the reference; the cache's spec (the xLSTM's
    C split by heads, whole on (1, 4)), and the hybrid's SSM states split
    by heads over "model" and its buffers whole."""
    got = runs[mesh][0][("decode", case)]
    for want in (runs["ref"][case], runs["jax"][case]):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert rel(got["logits"], want["logits"]) <= GRAD_RTOL
        for key in STATE_KEYS[case]:
            if float32_state(key):
                assert rel(got[key], want[key]) <= GRAD_RTOL, key
            else:
                assert within_one_bf16_ulp(got[key], want[key]), key
    if case in TW.XLSTM_CASES:
        assert got["cache_spec"] == XLSTM_C_SPEC[mesh]
    else:
        assert got["cache_spec"] == (None, *DECODE_SPEC[(case, mesh)],
                                     None)
    if case in TW.HYBRID_CASES:
        assert got["ssm_spec"] == ((None, "data", "model", None, None),
                                   (None, "data", None, None))


@pytest.mark.parametrize("mesh,case", DECODE_RUNS)
def test_decode_bitwise_on_every_rank(runs, mesh, case):
    """The gathered tokens, logits and state: the same bits on every
    rank, and two steps from one state the same bits."""
    first = runs[mesh][0][("decode", case)]
    for rank, got in enumerate(runs[mesh]):
        got = got[("decode", case)]
        assert got["run_to_run"], rank
        for key in ("tokens", "logits", *STATE_KEYS[case]):
            np.testing.assert_array_equal(got[key], first[key],
                                          err_msg=f"{rank} {key}")


@pytest.mark.parametrize("case", list(TW.DECODE))
def test_decode_one_rank_mesh_is_bitwise_the_unsharded_step(runs, case):
    """(1, 1), by kv heads or (``internlm2-seq``) along the sequence."""
    got, want = runs["1x1"][0][("decode", case)], runs["ref"][case]
    for key in ("tokens", "logits", *STATE_KEYS[case]):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# the mixture of experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", TW.MOE_CASES)
def test_moe_routing_margin_precondition(runs, case):
    """Every routing of the unsharded run (each layer's, and the decode
    step's) has its tokens' k + 1 largest probabilities at least
    ``ROUTING_MARGIN`` apart, so no layout or package can order them
    otherwise: the precondition of the MoE cases held above."""
    assert runs["ref"][case]["margin"] > TW.ROUTING_MARGIN


def test_moe_data_split_keeps_the_unsharded_bits(runs):
    """(2, 1): the batch split over "data", every rank routes the whole
    batch (its gathered token matrix) as the unsharded step does, and the
    prefill's logits are bitwise the unsharded ones. (The decode step's
    are not: a one-sequence block's attention products are made by other
    kernels than the two-sequence batch's; its tokens are held equal
    above.)"""
    got = runs["2x1"][0][("case", "qwen3-moe")]
    np.testing.assert_array_equal(got["logits"],
                                  runs["ref"]["qwen3-moe"]["logits"])
