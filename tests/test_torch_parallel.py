"""Port parity of the parallel layer's pieces against the JAX package on
the CPU: the partition rules (specs and shard shapes over the tiny and 7b
trees, no weights), the zig-zag permutation and the log-sum-exp combine,
and ring attention: ``ring_attention_local`` against JAX's
``ring_attention`` over the simulated 8-device mesh (forward; Pallas in
interpret mode) and against ``jax.grad`` of JAX's causal attention
(gradients), bar rtol 2e-3 / atol 2e-5 (``tests/test_ring_attention.py``'s
forward bar); then the ``gloo`` ring over 2 and 4 processes against the
local ring: the same steps on the same chunks, the exchange only copies
(outputs and q gradients bit for bit, k/v gradients summed in another
association)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu.models import fusion as jfusion
from macaw_llm_tpu.ops import causal_mask, dot_product_attention
from macaw_llm_tpu.parallel import ring_attention as jring
from macaw_llm_tpu.parallel import sharding as jsharding
from macaw_llm_tpu.parallel.mesh import create_mesh as jcreate_mesh
from macaw_llm_tpu.train.lora import init_lora as jinit_lora
from macaw_llm_tpu.utils.quantize import quantize_llama as jquantize_llama
from macaw_llm_tpu_torch.parallel import ring_attention as tring
from macaw_llm_tpu_torch.parallel import sharding as tsharding
from macaw_llm_tpu_torch.parallel.dryrun import spawn

MESHES = [(1, 1, 2, 4), (1, 2, 2, 2), (1, 1, 8, 1)]
AXES = ("dcn", "data", "fsdp", "tensor")


def _jmesh(shape):
    c, d, f, t = shape
    return jcreate_mesh(jconfig.MeshConfig(dcn=c, data=d, fsdp=f, tensor=t))


def _abstract_tree(name: str) -> dict:
    """The model's parameter shapes with LoRA adapters, and the LLaMA as
    int8 records beside it (the QLoRA base), as JAX lays them out."""
    cfg = {"tiny": jconfig.tiny_model_config, "7b": jconfig.macaw_7b}[name]()
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda: jfusion.init_params(key, cfg))
    tree["llm"]["layers"]["lora"] = jax.eval_shape(
        lambda: jinit_lora(key, cfg.llm, 8))
    tree["llm_int8"] = jax.eval_shape(jquantize_llama, tree["llm"])
    return tree


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _paths(v, f"{prefix}/{k}" if prefix else k)
        return out
    # the int8 copy reads as the LLaMA its records replace
    return [(prefix.replace("llm_int8/", "llm/"), tuple(tree.shape))]


@pytest.mark.parametrize("name", ["tiny", "7b"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_specs_and_shard_shapes_match_jax(name, shape):
    """Every leaf's spec (the indivisible vocab 32007 and the size-1 axes
    dropped, trailing Nones trimmed) and its shard's shape equal JAX's."""
    jmesh = _jmesh(shape)
    sizes = dict(zip(AXES, shape))
    leaves = _paths(_abstract_tree(name))
    cut = 0
    for path, shp in leaves:
        ref = jsharding.spec_for(path, shp, jmesh)
        got = tsharding.spec_for(path, shp, sizes)
        assert got == tuple(ref), (path, got, ref)
        assert tsharding.shard_shape(shp, got, sizes) == \
            NamedSharding(jmesh, ref).shard_shape(shp), path
        cut += any(got)
    assert cut > len(leaves) // 4  # the rules do cut
    # the embedding's vocab rows never divide: only its hidden dim is cut
    emb = dict(leaves)["llm/embed_tokens"]
    assert tsharding.spec_for("llm/embed_tokens", emb, sizes)[:1] == (None,)


def test_opt_state_specs_mirror_params():
    tree = {"llm": {"lm_head": torch.zeros(64, 128),
                    "norm": torch.zeros(64)}}
    sizes = {"dcn": 1, "data": 1, "fsdp": 2, "tensor": 4}
    specs = tsharding.infer_shardings(tree, sizes)
    assert specs == {"llm": {"lm_head": ("fsdp", "tensor"), "norm": ()}}
    assert tsharding.opt_state_shardings(tree, specs) == specs


@pytest.mark.parametrize("s,n", [(64, 4), (32, 2), (48, 3), (64, 8)])
def test_zigzag_and_inverse_match_jax(s, n):
    perm = tring.zigzag_indices(s, n)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(jring.zigzag_indices(s, n)))
    np.testing.assert_array_equal(
        tring.inverse_permutation(perm).numpy(),
        np.asarray(jring.inverse_permutation(jnp.asarray(perm.numpy()))))
    with pytest.raises(ValueError):
        tring.zigzag_indices(s + 1, n)


def test_combine_matches_jax_neg_inf_rows_included():
    rng = np.random.RandomState(0)
    oa, ob = (rng.randn(2, 6, 3, 4).astype(np.float32) for _ in range(2))
    la, lb = (rng.randn(2, 6, 3).astype(np.float32) * 3 for _ in range(2))
    neg = np.float32(tring.NEG_INF)
    assert np.isfinite(neg) and neg == np.finfo(np.float32).min
    la[0, 0] = neg           # one side masked
    lb[1, 2] = neg
    la[1, 3], lb[1, 3] = neg, neg   # both masked
    oa[0, 0] = 0.0
    ob[1, 2] = 0.0
    ref = jring._combine(*(jnp.asarray(x) for x in (oa, la, ob, lb)))
    got = tring._combine(*(torch.from_numpy(x) for x in (oa, la, ob, lb)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
    # a masked side leaves the other unchanged
    np.testing.assert_array_equal(got[0][0, 0].numpy(), ob[0, 0])
    np.testing.assert_array_equal(got[1][1, 2].numpy(), la[1, 2])


def _qkv(s=64, seed=0):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(2, s, 2, 16) * 0.5).astype(np.float32)
                 for _ in range(4))


def _order(layout, s, n):
    return (np.asarray(jring.zigzag_indices(s, n)) if layout == "zigzag"
            else np.arange(s))


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's causal attention over the whole sequence and its gradients of
    sum(out * g)."""
    q, k, v, g = _qkv()
    s = q.shape[1]

    def loss(q, k, v):
        return (dot_product_attention(q, k, v, causal_mask(s, s))
                * g).sum()

    out = dot_product_attention(q, k, v, causal_mask(s, s))
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_local_ring_matches_jax_ring(n, layout, jax_reference):
    q, k, v, g = _qkv()
    s = q.shape[1]
    order = _order(layout, s, n)
    inv = np.argsort(order)
    block = s // (2 * n)
    mesh = _jmesh((1, 1, 8 // n, n))
    jout = jring.ring_attention(*(jnp.asarray(x[:, order]) for x in (q, k, v)),
                                mesh=mesh, axis="tensor", layout=layout,
                                block_q=block, block_k=block)
    x = [torch.from_numpy(t[:, order].copy()).requires_grad_()
         for t in (q, k, v)]
    out = tring.ring_attention_local(*x, n, layout)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-3, atol=2e-5)
    ref_out, ref_grads = jax_reference
    np.testing.assert_allclose(out.detach().numpy()[:, inv], ref_out,
                               rtol=2e-3, atol=2e-5)
    grads = torch.autograd.grad((out * torch.from_numpy(
        g[:, order].copy())).sum(), x)
    for got, ref, name in zip(grads, ref_grads, "qkv"):
        np.testing.assert_allclose(got.numpy()[:, inv], ref, rtol=2e-3,
                                   atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ring_gives_the_local_rings_bits(world, tmp_path):
    """``ring_attention`` over ``world`` gloo processes, both layouts in
    one job: each rank's output chunk and q gradient chunk are the local
    ring's bits (the same steps on the same chunks, the same sums in the
    same order). The k/v gradients are not always: a chunk's contributions
    from the ranks it visits come back along the exchange chain, each rank
    adding its own to what the later ones sent, while the local ring's
    autograd adds them up in its own order; the same terms in another
    association, held to 1e-5 of the largest."""
    q, k, v, g = _qkv(seed=1)
    s = q.shape[1]
    layouts = ("contiguous", "zigzag")
    files, local = {}, {}
    for layout in layouts:
        order = _order(layout, s, world)
        t = [torch.from_numpy(x[:, order].copy()) for x in (q, k, v, g)]
        files[layout] = str(tmp_path / f"{layout}.pt")
        torch.save(t, files[layout])
        x = [a.clone().requires_grad_() for a in t[:3]]
        out = tring.ring_attention_local(*x, world, layout)
        local[layout] = (out.detach(),
                         torch.autograd.grad((out * t[3]).sum(), x))
    res = spawn(world, "ring", {"qkv": files, "layouts": layouts},
                str(tmp_path / "job"))
    for layout in layouts:
        out, grads = local[layout]
        for r, got in enumerate(res):
            got = got[layout]
            assert torch.equal(got["out"], out.chunk(world, 1)[r]), \
                (layout, r)
            dq, dk, dv = got["grads"]
            assert torch.equal(dq, grads[0].chunk(world, 1)[r]), (layout, r)
            for a, b, name in ((dk, grads[1], "dk"), (dv, grads[2], "dv")):
                b = b.chunk(world, 1)[r]
                err = (a - b).abs().max().item()
                assert err <= 1e-5 * b.abs().max().item(), (layout, r, name,
                                                            err)


@pytest.mark.parametrize("backend,card", [(None, 3), ("nccl", 3),
                                          ("gloo", 1)])
def test_multihost_initialize_takes_the_local_ranks_card(monkeypatch,
                                                         backend, card):
    """On cuda a rank takes the card of its local rank. Only an explicit
    gloo backend folds the local rank onto the cards there are (several
    ranks on one card); NCCL's default keeps the rank's own index, so a job
    with more local ranks than cards fails at ``set_device``."""
    import torch.distributed as dist

    from macaw_llm_tpu_torch.parallel import mesh as tmesh
    took, joined = [], {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: joined.update(kw))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", took.append)
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tmesh.multihost_initialize("cuda", backend=backend)
    assert took == [card]
    assert joined["backend"] == (backend or "nccl") and joined["rank"] == 3
