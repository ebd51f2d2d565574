"""Shared helpers of the port's language-model tests: a reduced config on
both sides, the reference's weights carried across by ``params_from_jax``,
and the checks that hold the port's prefill, decode, decode state and
``ServeLoop`` against the reference's.

Tolerances (float32 on both sides, sums in another order): per block
atol 5e-5 / rtol 5e-4, as ``tests/test_kernels.py``; whole model rtol
1e-3 and atol 1e-3 of the leaf's largest magnitude (at least 1), as
``tests/test_torch_xlstm.py``, because each random-weight layer amplifies
a difference in its input."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as ref_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.models import build_model as ref_build
from repro.models import make_batch as ref_make_batch
from repro.serving import ServeLoop as RefLoop
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.models.transformer import (params_from_jax, state_from_jax,
                                            state_to_jax)
from repro_torch.serving import LarkSessionStore, ServeLoop


def configs(arch, **kw):
    """The reduced config of `arch` (with `kw` replaced) on both sides."""
    rcfg = ref_reduced(arch).replace(**kw)
    tcfg = reduced_config(arch).replace(**kw)
    assert repr(rcfg) == repr(tcfg)
    return rcfg, tcfg


def models(arch, **kw):
    """(cfg, jitted reference model, its PRNGKey(0) weights, the port's
    model, the same weights as tensors)."""
    rcfg, tcfg = configs(arch, **kw)
    ref = ref_build(rcfg)
    pj = ref["init_params"](jax.random.PRNGKey(0))
    ref = dict(ref, prefill=jax.jit(ref["prefill"], static_argnames="max_len"),
               decode_step=jax.jit(ref["decode_step"]))
    return (tcfg, ref, pj, build_model(tcfg),
            params_from_jax(tcfg, jax.tree.map(np.asarray, pj)))


def batch(cfg, seq, rows=2, seed=0):
    """The reference's make_batch for a prefill of `seq` positions, as
    numpy arrays."""
    b = ref_make_batch(cfg, RefShape("t", seq, rows, "prefill"),
                       np.random.default_rng(seed))
    return {k: np.array(v) for k, v in b.items()}


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def close(got, want, atol=5e-5, rtol=5e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def close_deep(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3,
                               atol=1e-3 * scale)


def layer_params(cfg, stack, li):
    """Layer li's reference parameters, sliced out of its segment stack."""
    for si, (pattern, repeats) in enumerate(cfg.layout):
        n = len(pattern) * repeats
        if li < n:
            return jax.tree.map(lambda a: a[li // len(pattern)],
                                stack[si][li % len(pattern)])
        li -= n
    raise IndexError(li)


def run_both(m, b, max_len, steps=4, inputs=None):
    """Prefill both models on the numpy batch b, then `steps` decode
    steps: greedy (the argmax fed back, equal on both sides) or, for an
    embeds-input model, the given (input, positions) of each step.
    Returns [(port logits, reference logits, port state, reference
    state)] for the prefill and every step."""
    _, ref, pj, port, pt = m
    prompt = next(b[k].shape[1] for k in ("tokens", "embeds") if k in b)
    lj, sj = ref["prefill"](pj, jax.tree.map(jnp.asarray, b),
                            max_len=max_len)
    lt, st = port["prefill"](pt, to_torch(b), max_len)
    out = [(lt, lj, st, sj)]
    for i in range(steps):
        if inputs is None:
            cur = jnp.argmax(lj, -1).astype(jnp.int32)
            assert np.array_equal(np.asarray(cur),
                                  lt.argmax(-1).to(torch.int32).numpy())
            xj, xt, kj, kt = cur, torch.from_numpy(np.array(cur)), {}, {}
        else:
            x, positions = inputs[i]
            xj, xt = jnp.asarray(x), torch.from_numpy(x)
            kj = {"positions": jnp.asarray(positions)}
            kt = {"positions": torch.from_numpy(positions)}
        lj, sj = ref["decode_step"](pj, sj, xj, jnp.int32(prompt + i), **kj)
        lt, st = port["decode_step"](pt, st, xt, prompt + i, **kt)
        out.append((lt, lj, st, sj))
    return out


def states_close(cfg, st, sj):
    """Every decode-state leaf: the reference's tree structure, shapes
    and dtypes, int32 positions equal, floats within the whole-model
    tolerance; and the converters invert each other on the reference's
    own state."""
    want = jax.tree.map(np.asarray, sj)
    got = state_to_jax(cfg, st)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.int32:
            assert np.array_equal(g, w)
        else:
            close_deep(g, w)
    back = state_to_jax(cfg, state_from_jax(cfg, want))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.array_equal(g, w)


def model_matches(m, b, max_len, steps=4, inputs=None):
    """Prefill logits, every logit of `steps` decode steps, and the
    decode state after the prefill and after the last step."""
    cfg = m[0]
    out = run_both(m, b, max_len, steps, inputs)
    for lt, lj, _, _ in out:
        close_deep(lt, lj)
    for _, _, st, sj in (out[0], out[-1]):
        states_close(cfg, st, sj)
    return out


def decode_state_shape_matches(m, batch_size=3, max_len=16):
    cfg, ref, _, port, _ = m
    want = jax.tree.leaves(ref["decode_state_shape"](batch_size, max_len))
    zeros = [jax.tree.map(lambda spec: torch.zeros(spec[0], dtype=spec[1]),
                          st, is_leaf=lambda x: isinstance(x, tuple))
             for st in port["decode_state_shape"](batch_size, max_len)]
    got = jax.tree.leaves(state_to_jax(cfg, zeros))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype


def serve_matches(m, b, max_len, gen=8, resume=4):
    """ServeLoop's greedy tokens equal the reference ServeLoop's, and a
    session resumed after fail_server(0) equals the uninterrupted run."""
    cfg, _, pj, _, pt = m
    want = np.asarray(RefLoop(cfg, pj, max_len=max_len).generate(
        jax.tree.map(jnp.asarray, b), steps=gen + resume))
    sess = LarkSessionStore(num_nodes=4, rf=2)
    loop = ServeLoop(cfg, pt, max_len=max_len, session_store=sess,
                     checkpoint_every=4, device="cpu")
    got = loop.generate(b, steps=gen, session_id="s")
    np.testing.assert_array_equal(got, want[:, :gen])
    sess.fail_server(0)
    np.testing.assert_array_equal(loop.resume("s", steps=resume), want)


def params_cross(m, stacks=(("blocks", None),)):
    """Every leaf of every layer of the named stacks equals the
    reference's slice of its stacked leaf, bit for bit (``None``: the
    config's own layout; else the config to unstack by)."""
    cfg, _, pj, _, pt = m
    for name, scfg in stacks:
        scfg = scfg or cfg
        assert len(pt[name]) == scfg.num_layers
        for li in range(scfg.num_layers):
            want = lm_leaves(layer_params(scfg, pj[name], li))
            got = lm_leaves(pt[name][li])
            assert [k for k, _ in got] == [k for k, _ in want]
            for (_, g), (_, w) in zip(got, want):
                w = np.array(w)
                assert g.dtype == torch.from_numpy(w).dtype
                assert torch.equal(g, torch.from_numpy(w))


def lm_leaves(tree):
    """(path, leaf) pairs in the order jax flattens a dict."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in flat]


def train_batch(cfg, seq=16, rows=2, seed=0):
    """The reference's make_batch for a train cell (labels included), as
    numpy arrays."""
    b = ref_make_batch(cfg, RefShape("t", seq, rows, "train"),
                       np.random.default_rng(seed))
    return {k: np.array(v) for k, v in b.items()}


def ref_loss_and_grads(ref_model, pj, b):
    """jax.value_and_grad of the reference's loss_fn on the numpy batch:
    (total, metrics, grads as numpy float32)."""
    fn = jax.jit(jax.value_and_grad(ref_model["loss_fn"], has_aux=True))
    (total, metrics), grads = fn(pj, jax.tree.map(jnp.asarray, b))
    return total, metrics, jax.tree.map(
        lambda a: np.asarray(a, np.float32), grads)


def grads_close(cfg, got, want_np):
    """Every gradient leaf of the port (a tree of tensors in the port's
    layout) within the whole-model tolerance of the reference's (its
    pytree, as numpy), matched by ``params_from_jax``."""
    from repro_torch import tree
    want = params_from_jax(cfg, want_np)
    got_leaves = tree.leaves_with_paths(got)
    want_leaves = tree.leaves_with_paths(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.shape == w.shape, path
        close_deep(g.to(torch.float32), w.to(torch.float32))
