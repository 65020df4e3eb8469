"""GRU hidden widths the kernels do not take as they are, against the JAX
package: an H off a multiple of 32 (the wrappers pad it with zero units,
``ops/kernels/gru.py:pad_hidden``), an H above 512 (the wide kernel
pair on the card; the JAX package runs its ``lax.scan`` there) and above
2048 (the grid design on the card), up to a tiny FBCRNN whose heads are
at ``rnn_config(9)``'s 2304.

Every input is made from a seeded numpy ``RandomState`` and handed to
both packages; the port runs its kernels' plain versions (CPU tensors, no
launch). Tolerances:

- the padding: the padded units' outputs and gradients are zero in every
  bit; the real units equal the unpadded plain version to f32 summation
  order, not bit for bit: the CPU's ``bmm`` cuts a longer K into other
  blocks, so a zero-padded product sums in another order (1 f32 ulp of
  h, measured), which can move a later bf16 rounding of dxw by one bf16
  ulp: ``2 ** -8 * max|ref|`` for the backward, ``1e-6 * max|ref|`` for
  the forward up to H = 2048. Above it (K = 2100 against 2112) the
  product itself moves by an f32 ulp (3.4e-5 on sums of ~45, measured),
  and a later bf16 rounding of the carried h with it: the forward is held
  to ``2 ** -8 * max|ref|`` too;
- against JAX: the GRU ceiling, 5.3e-3 forward and 5.3e-3 of each
  gradient's largest entry (``tests/test_torch_gru.py``). Above 512 the
  port keeps its rounding points (bf16 xw) where JAX's scan keeps xw in
  f32 and sums dw_hh in bf16 (``ROADMAP.md`` §3); the distance is within
  the same ceiling, but for dw_hh, held to JAX's own bf16 sum's error,
  and at 2304 for the input projection's gradients (dw_ih and the
  input's), which both packages round to bf16 and which are held to one
  bf16 ulp of their largest entry, 2^-7 of it;
- the FBCRNN: ``1e-4 + 3e-2 * max|ref|`` for scores
  (``tests/test_torch_fbcrnn.py``).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.models import weak_label as jweak
from pb_sed_tpu.models.base.model import (flatten_variables,
                                          unflatten_variables)
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.ops.pallas.gru import gru_scan as jax_gru_scan
from pb_sed_tpu.utils.config import config_to_json
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models.base.model import port_config
from pb_sed_tpu_torch.ops import rnn as trnn
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.gru import (GruScan, gru_scan,
                                              gru_scan_bwd,
                                              gru_scan_bwd_plain,
                                              gru_scan_plain, pack_grid,
                                              pad_hidden, padded_hidden,
                                              unpad_hidden)
from pb_sed_tpu_torch.utils.config import instantiate
from tests import test_torch_fbcrnn as fbcrnn_tests

torch.set_num_threads(2)

CEILING = 5.3e-3


def _inputs(d, b, t, h, seed=0):
    rng = np.random.RandomState(seed)
    xw = rng.randn(d, b, t, 3 * h).astype(np.float32)
    w_hh = (rng.randn(d, h, 3 * h) / np.sqrt(h)).astype(np.float32)
    b_hh = (.1 * rng.randn(d, 3 * h)).astype(np.float32)
    h0 = (.5 * rng.randn(d, b, h)).astype(np.float32)
    return xw, w_hh, b_hh, h0


def _max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


@pytest.mark.parametrize('h', [1, 48, 200, 600, 1000, 1100, 2100])
def test_padding_is_exact(h):
    """pad -> plain version at the padded H -> slice, against the plain
    version at the real H, forward and the split backward's dxw, dw_hh,
    db_hh and dh0; the padded units stay at zero in every output. The
    padded H is the next multiple of 32 up to 512, of 256 up to 2048 (the
    cluster design of 16 blocks of H / 16 units: 600 -> 768, 1000 -> 1024,
    1100 -> 1280) and of 64 above (the grid design's K chunk: 2100 ->
    2112)."""
    hp = padded_hidden(h)
    step = 32 if h <= 512 else 256 if h <= 2048 else 64
    assert hp % step == 0 and hp - step < h <= hp
    t = 7
    xw, w_hh, b_hh, h0 = map(torch.from_numpy, _inputs(2, 3, t, h))
    g = torch.from_numpy(np.random.RandomState(1).randn(2, 3, t, h)
                         .astype(np.float32))
    y = gru_scan_plain(xw, w_hh, b_hh, h0)
    padded = pad_hidden(xw, w_hh, b_hh, h0, hp=hp)
    assert padded[0].shape == (2, 3, t, 3 * hp)
    assert padded[1].shape == (2, hp, 3 * hp)
    y_pad = gru_scan_plain(*padded)
    assert not y_pad[..., h:].any()
    got = unpad_hidden(h, y=y_pad)[0]
    assert _max_err(got, y) <= (1e-6 if h <= 2048 else 2. ** -8) * float(
        y.abs().max())
    ref = gru_scan_bwd_plain(xw, w_hh, b_hh, h0, y, g)
    out = gru_scan_bwd_plain(*pad_hidden(xw, w_hh, b_hh, h0, y, g, hp=hp))
    dxw, dw_hh, db_hh, dh0 = out
    assert not dxw.reshape(2, 3, t, 3, hp)[..., h:].any()
    assert not dw_hh[:, h:].any()
    assert not dw_hh.reshape(2, hp, 3, hp)[..., h:].any()
    assert not db_hh.reshape(2, 3, hp)[..., h:].any()
    assert not dh0[..., h:].any()
    for name, a, r in zip(('dxw', 'dw_hh', 'db_hh', 'dh0'),
                          unpad_hidden(h, None, *out)[1:], ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert _max_err(a, r) <= 2. ** -8 * float(r.float().abs().max()), \
            name


@pytest.mark.parametrize('dh', [False, True])
def test_pack_grid_puts_each_weight_where_the_grid_kernels_read_it(dh):
    """``pack_grid`` (the grid design's w_hh above H = 2048) at H = 128,
    D = 2: every entry w_hh[d, k, c] (c = g H + u) lies where
    ``csrc/gru_grid.cuh`` reads it. The gate product's chunk (unit tile
    j, K chunk kc) is 3072 values, matrix (k8 kb, gate g, unit half nh) at
    ((kb * 3 + g) * 2 + nh) * 64, row k % 8 of 8 units; the dh product's
    (tile j of rows k, column chunk kc) 1024 values, matrix (column 8 cb,
    row half uh) at (cb * 2 + uh) * 64, row k % 8 of 8 columns."""
    d, h = 2, 128
    w = torch.arange(d * h * 3 * h, dtype=torch.float32).reshape(d, h, 3 * h)
    chunk = 1024 if dh else 3072
    packed = pack_grid(w, dh=dh).reshape(d, h // 16, -1, chunk)
    k, c = np.meshgrid(np.arange(h), np.arange(3 * h), indexing='ij')
    if dh:
        kc, rest = np.divmod(c, 64)
        at = (k // 16, kc, (rest // 8 * 2 + k % 16 // 8) * 64
              + k % 8 * 8 + rest % 8)
    else:
        gate, u = np.divmod(c, h)
        kc, rest = np.divmod(k, 64)
        at = (u // 16, kc, ((rest // 8 * 3 + gate) * 2 + u % 16 // 8) * 64
              + rest % 8 * 8 + u % 8)
    for i in range(d):
        assert torch.equal(packed[i][at], w[i])


def test_the_cpu_takes_any_hidden_size_without_a_launch():
    """A CPU tensor runs the plain version at any H, here 4100 (which the
    card runs on the grid design as 4160), forward and backward, and
    launches nothing."""
    h = 4100
    xw, w_hh, b_hh, h0 = map(torch.from_numpy, _inputs(1, 2, 2, h))
    build.reset_launches()
    y = gru_scan(xw, w_hh, b_hh, h0)
    assert y.shape == (1, 2, 2, h)
    grads = gru_scan_bwd(xw, w_hh, b_hh, h0, y, torch.ones_like(y))
    assert [tuple(a.shape) for a in grads] == [
        (1, 2, 2, 3 * h), (1, h, 3 * h), (1, 3 * h), (1, 2, h)]
    assert not any(build.LAUNCHES.values())


def test_gru_at_200_matches_the_pallas_kernel():
    """H = 200 (the kernels run it as 224): ``GruScan`` forward and
    gradients against the JAX package's Pallas GRU and its custom VJP in
    interpret mode (which takes any H <= 512), B = 3, T = 9, a random
    initial state."""
    d, b, t, h = 2, 3, 9, 200
    xw, w_hh, b_hh, h0 = _inputs(d, b, t, h, seed=2)
    g = np.random.RandomState(3).randn(d, b, t, h).astype(np.float32)
    jrnn.set_pallas_mode('force_interpret')
    try:
        y_ref, vjp = jax.vjp(lambda *a: jax_gru_scan(*a, True),
                             *map(jnp.asarray, (xw, w_hh, b_hh, h0)))
        ref = vjp(jnp.asarray(g))
    finally:
        jrnn.set_pallas_mode('auto')
    args = [torch.from_numpy(a).requires_grad_()
            for a in (xw, w_hh, b_hh, h0)]
    y = GruScan.apply(*args)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=CEILING, rtol=0)
    grads = torch.autograd.grad(y, args, torch.from_numpy(g))
    for name, got, r in zip(('dxw', 'dw_hh', 'db_hh', 'dh0'), grads, ref):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(
            got.numpy(), r, rtol=0, atol=CEILING * float(np.abs(r).max()),
            err_msg=name)


def _jax_layer_grads(module, flat, x, g, *args):
    """Output and the gradients (params and input) of ``sum(y * g)`` of a
    JAX recurrent module."""
    variables = jax.tree_util.tree_map(jnp.asarray, _unflatten(flat))

    def run(params, x):
        y = module.apply({'params': params}, x, *args)
        return jnp.sum(y * g), y

    (_, y), (gp, gx) = jax.value_and_grad(run, argnums=(0, 1),
                                          has_aux=True)(
        variables['params'], jnp.asarray(x))
    return (np.asarray(y), dict(flatten_variables({'params': gp}),
                                input=np.asarray(gx)))


def _unflatten(flat):
    from pb_sed_tpu.models.base.model import unflatten_variables
    return unflatten_variables(flat)


def _port_layer_grads(module, flat, x, g, *args):
    bridge.load_flat(module, flat)
    xt = torch.from_numpy(x).requires_grad_()
    y = module(xt, *args)
    (y * torch.from_numpy(g)).sum().backward()
    grads = {f'params.{n}': p.grad.numpy() for n, p in
             module.named_parameters()}
    return y.detach().numpy(), dict(grads, input=xt.grad.numpy())


WIDE = 768
# rnn_config(9)'s hidden size (256 x 9), the first above 2048 that
# net_configs reaches: the grid design on the card
GRID_WIDE = 2304
F_IN = 24


def _wide_case(kind, h=WIDE):
    """(JAX module, port module, extra call arguments) of a GRU at
    hidden size h: one unidirectional layer, a stacked pair of layers, one
    bidirectional layer over clips of unequal lengths."""
    seq_len = np.array([9, 6, 3], np.int32)
    if kind == 'layer':
        return (jrnn.GRULayer(h, F_IN),
                trnn.GRULayer(h, F_IN), (), ())
    if kind == 'stacked':
        return (jrnn.StackedGRU(h, num_layers=2, input_size=F_IN),
                trnn.StackedGRU(h, num_layers=2, input_size=F_IN),
                (jnp.asarray(seq_len),), (torch.from_numpy(seq_len),))
    return (jrnn.BiGRULayer(h), trnn.BiGRULayer(h, F_IN),
            (jnp.asarray(seq_len),), (torch.from_numpy(seq_len),))


@pytest.mark.parametrize('kind,h', [
    pytest.param(kind, h, id=kind if h == WIDE else f'{kind}-{h}')
    for h in (WIDE, GRID_WIDE)
    for kind in ('layer', 'stacked', 'bidirectional')])
def test_wide_layers_match_the_jax_scan(kind, h):
    """``GRULayer``, a 2-layer ``StackedGRU`` and ``BiGRULayer`` at
    H = 768 (the wide kernel pair on the card) and 2304 (the grid design)
    against the JAX modules, which run their ``lax.scan`` above
    ``PALLAS_MAX_HIDDEN``: output and every gradient (parameters and
    input) of ``sum(y * g)``, B = 3, T = 9, within the GRU ceiling (dw_hh
    within JAX's own bf16 sum's error, below)."""
    jmod, tmod, jargs, targs = _wide_case(kind, h)
    rng = np.random.RandomState(5)
    x = rng.randn(3, 9, F_IN).astype(np.float32)
    # the JAX module's keys and shapes, built abstractly (its init would
    # run the orthogonal initializer and the scan)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x), *jargs))
    flat = bridge.random_flat(flatten_variables(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), dict(shapes))), 11)
    assert sorted(flat) == sorted(bridge.export_flat(tmod))
    out = h * (2 if kind == 'bidirectional' else 1)
    g = rng.randn(3, 9, out).astype(np.float32)
    y_ref, ref = _jax_layer_grads(jmod, flat, x, g, *jargs)
    build.reset_launches()
    y, got = _port_layer_grads(tmod, flat, x, g, *targs)
    assert build.LAUNCHES['gru_scan'] == 0
    np.testing.assert_allclose(y, y_ref, atol=CEILING, rtol=0)
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        # JAX's scan sums dw_hh over the steps in bf16 (the dot's
        # transpose gives w_hh's bf16 copy its cotangent in bf16): its
        # own error reaches half a bf16 ulp a step, T * 2^-9 of the
        # largest entry; the port sums in f32
        rel = max(CEILING, 9 * 2. ** -9) if key.endswith('w_hh') \
            else CEILING
        if h > WIDE and (key == 'input' or key.endswith('w_ih')):
            # both packages round the input projection's gradients to
            # bf16 (the transpose of its bf16 dot, ops/linear.py:
            # Bf16Linear): two roundings of sums taken in another order
            # differ by up to one bf16 ulp of an entry, 2^-7 of the
            # largest (at 2304 the stacked pair has one entry one ulp off
            # in each: 0.0625 at 9.56 of dw_ih, at 8.06 of the input's)
            rel = max(CEILING, 2. ** -7)
        np.testing.assert_allclose(
            got[key], r, rtol=0, atol=rel * float(np.abs(r).max()),
            err_msg=key)


def test_wide_members_fold_into_the_direction_axis():
    """Two members' D = 2 recurrences at H = 768 under
    ``torch.func.vmap`` (the stacked ensemble's one launch at D = 4)
    equal the two single calls, forward and the backward's outputs."""
    xw, w_hh, b_hh, h0 = map(torch.from_numpy, _inputs(4, 3, 5, WIDE))
    g = torch.from_numpy(np.random.RandomState(6).randn(4, 3, 5, WIDE)
                         .astype(np.float32))
    member = (lambda a: a.reshape(2, 2, *a.shape[1:]))
    got = torch.func.vmap(GruScan.apply)(*map(member, (xw, w_hh, b_hh, h0)))
    singles = [gru_scan(xw[i:i + 2], w_hh[i:i + 2], b_hh[i:i + 2],
                        h0[i:i + 2]) for i in (0, 2)]
    assert torch.equal(got.reshape(4, 3, 5, WIDE), torch.cat(singles))
    y = torch.cat(singles)
    folded = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g)
    for i in (0, 2):
        single = gru_scan_bwd(xw[i:i + 2], w_hh[i:i + 2], b_hh[i:i + 2],
                              h0[i:i + 2], y[i:i + 2], g[i:i + 2])
        for a, s in zip(folded, single):
            assert torch.equal(a[i:i + 2], s)


def test_fbcrnn_with_heads_above_2048_from_the_jax_config_matches_jax():
    """A tiny-tower FBCRNN whose paired heads are at 2304 (the grid design
    on the card), built from the JAX package's config (its factories,
    ``port_config`` maps them) with the weights a training run starts
    from (``bridge.init_flat``: w_hh with orthonormal rows, 2304 x 6912 a
    direction) loaded into both: tagging and SED (window 11, shift 1)
    against the JAX model, whose heads run their ``lax.scan``, within
    ``1e-4 + 3e-2 * max|ref|``, no launch."""
    config = pickle.loads(pickle.dumps(fbcrnn_tests.CONFIG))
    config['rnn_fwd']['rnn'].update(hidden_size=GRID_WIDE, num_layers=1)
    batches = fbcrnn_tests._batches()
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(
        pickle.loads(pickle.dumps(config))))
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()
             if k != 'example_id'}
    shapes = jax.eval_shape(lambda: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, batch, training=False))
    template = flatten_variables(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), dict(shapes)))
    tmodel = instantiate(port_config(config_to_json(
        jweak.CRNN.get_config(config)))).to('cpu')
    assert sorted(template) == sorted(bridge.export_flat(tmodel.module))
    flat = bridge.init_flat(template, 9)
    heads = [key for key in flat if key.endswith('w_hh')]
    assert len(heads) == 2
    for key in heads:
        w = flat[key].reshape(GRID_WIDE, 3 * GRID_WIDE)
        np.testing.assert_allclose(w[:64] @ w[:64].T, np.eye(64),
                                   atol=1e-5)
    jmodel.variables = jax.tree_util.tree_map(jnp.asarray,
                                              unflatten_variables(flat))
    bridge.load_flat(tmodel.module, flat)
    assert tmodel.module.rnn_bwd.rnn.hidden_size == GRID_WIDE
    build.reset_launches()
    batch = batches[1]
    jy, jsl = jmodel.tagging(batch)
    ty, tsl = tmodel.tagging(batch)
    np.testing.assert_array_equal(tsl, jsl)
    fbcrnn_tests._close(ty, jy)
    jy, jsl = jmodel.sound_event_detection(batch, 11, window_shift=1)
    ty, tsl = tmodel.sound_event_detection(batch, 11, window_shift=1)
    np.testing.assert_array_equal(tsl, jsl)
    fbcrnn_tests._close(ty, jy)
    assert not any(build.LAUNCHES.values())
