"""The arithmetic of K2's f32 kernels, backward and forward, emulated on
the CPU.

csrc/flash_attn_bwd.cu runs every f32 product on the tensor cores in the
3xTF32 split: each f32 operand x becomes hi = tf32(x) and lo = tf32(x - hi),
rounded to nearest with ties away from zero (PTX cvt.rna.tf32.f32: 10
explicit mantissa bits kept; csrc/mma_frag.cuh computes it with the two
integer operations tf32_rna uses here), and a·b is taken as a_lo·b_hi +
a_hi·b_lo + a_hi·b_hi with f32 accumulation. Here numpy rounds f32 to
TF32 the same way and torch forms each product of the backward (S, dP, dV, dK, dQ) from the
split in f32; the dQ, dK and dV that come out lie within grad_tolerance's
1e-5 of the largest value of a float64 evaluation, at the BERT-base head
shape [1, 12, 512, 64]. The same emulation with plain TF32 (one product of
the hi parts) does not, which is why the kernels split.

A tensor-core mma also rounds its f32 sum toward zero (exact products, one
rounding a call, always toward zero), so its error piles up with the
number of mma calls into one accumulator. The last test models that, one
8-deep mma at a time, and holds the kernels' order of work (the small
terms of every k first, then the big ones; each step's dK, dV or dQ in a
fresh partial added in f32) to the same 1e-5, where the plain order (three
mma per k into one accumulator) lands several times further off.

The forward kernel (csrc/flash_attn_fwd.cu) is emulated the same way, tile
by tile over 64 keys at [1, 2, 512, 64]: S = Q Kᵀ in the kernel order, the
online softmax in f32 in the log2 domain with the rescale of O, and each
tile's P V in a fresh partial added to the rescaled O. Its output lies
within flash_attention.tolerance (1e-5 of max|v|) of a float64 evaluation,
at 1-2% of it; plain TF32 misses it 6-20 times over. The plain order
(three mma per k, every tile's P V into O itself) lands 4-8 times further
off than the kernel order, though at this scale of the tolerance (max|v|,
where O is a convex combination of v's rows) it stays inside, at 6-7%.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa


def tf32_rna(x):
    """f32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero: add half of the dropped 13 bits to the magnitude,
    then clear them."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    x = x.numpy()
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)  # x - hi is exact in f32 (Sterbenz)
    return torch.from_numpy(hi), torch.from_numpy(lo)


def _mm(a, b, terms):
    """a @ b (batched) as the kernel forms it: f32 accumulation of
    a_lo·b_hi, a_hi·b_lo and a_hi·b_hi in that order (terms=3), or of
    a_hi·b_hi alone (terms=1, plain TF32)."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    if terms == 1:
        return a_hi @ b_hi
    acc = a_lo @ b_hi
    acc += a_hi @ b_lo
    acc += a_hi @ b_hi
    return acc


def _backward(q, k, v, do, lse, di, causal, scale, mm):
    """dQ, dK, dV of softmax(scale·q·kᵀ)·v in the kernels' order of work,
    each product through mm."""
    s = mm(q, k.transpose(-1, -2)) * scale
    if causal:
        sq, sk = q.shape[-2], k.shape[-2]
        keep = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
        s = s.masked_fill(~keep, float('-inf'))
    p = torch.exp(s - lse[..., None])
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - di[..., None]) * scale
    dv = mm(p.transpose(-1, -2).contiguous(), do)
    dk = mm(ds.transpose(-1, -2).contiguous(), q)
    dq = mm(ds, k)
    return dq, dk, dv


def _inputs(causal, seed=0, b=1, h=12, s=512, d=64):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
                   for _ in range(4))
    scale = d ** -0.5
    lse = fa.flash_attention_reference_lse(q.double(), k.double(), causal,
                                           scale).float()
    out = fa.flash_attention_reference(q.double(), k.double(), v.double(),
                                       causal, scale)
    di = (do.double() * out).sum(-1).float()
    return q, k, v, do, lse, di, scale


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


@pytest.mark.parametrize('causal', [False, True])
def test_3xtf32_backward_holds_the_f32_tolerance(causal):
    q, k, v, do, lse, di, scale = _inputs(causal)
    want = _backward(*(t.double() for t in (q, k, v, do, lse, di)), causal,
                     scale, torch.matmul)
    split = _backward(q, k, v, do, lse, di, causal, scale,
                      lambda a, b: _mm(a, b, 3))
    plain = _backward(q, k, v, do, lse, di, causal, scale,
                      lambda a, b: _mm(a, b, 1))
    for name, ref, got, tf32 in zip(('dq', 'dk', 'dv'), want, split, plain):
        tol = fa.grad_tolerance(ref.float())
        err = float((got.double() - ref).abs().max())
        err_tf32 = float((tf32.double() - ref).abs().max())
        assert err <= tol, (name, err, tol)
        # the emulation rounds for real: one TF32 product misses by far
        assert err_tf32 > 10 * tol, (name, err_tf32, tol)


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    x = np.array([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                  1 + 3 * ulp / 2, 3.0e-3, -7.5], np.float32)
    want = np.array([1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp,
                     np.nan, -7.5], np.float32)
    got = tf32_rna(x)
    np.testing.assert_array_equal(got[[0, 1, 2, 3, 4, 6]],
                                  want[[0, 1, 2, 3, 4, 6]])
    # any value: within half a TF32 step, with 13 low bits clear
    assert abs(float(got[5]) - 3.0e-3) <= 2.0 ** -11 * 3.0e-3
    assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()


def test_split_keeps_22_bits():
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(
        -3, 3, 4096)).astype(np.float32))
    hi, lo = _split(x)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21


def _rz(x):
    """float64 values rounded to f32 toward zero (kept as float64)."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y.astype(np.float64)


def _mm_rz(a, b, kernel_order, step=None, init=None):
    """a @ b as a chain of m16n8k8 TF32 mma calls on the 3xTF32 split,
    each adding 8 exact products to the accumulator and rounding toward
    zero. kernel_order: the small terms of every k first, then the big
    ones, and a fresh partial every `step` of k added to the sum in f32
    (mma_frag.cuh); else a_lo·b_hi, a_hi·b_lo, a_hi·b_hi per k into one
    accumulator, which holds `init` (f32) before the first mma if given."""
    a_hi, a_lo = (t.numpy().astype(np.float64) for t in _split(a))
    b_hi, b_lo = (t.numpy().astype(np.float64) for t in _split(b))
    depth = a.shape[-1]
    step = step if kernel_order and step else depth
    total = None
    for s0 in range(0, depth, step):
        blocks = range(s0, min(depth, s0 + step), 8)
        terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
        if kernel_order:
            seq = [(x, y, k) for x, y in terms[:2] for k in blocks] + [
                (a_hi, b_hi, k) for k in blocks]
        else:
            seq = [(x, y, k) for k in blocks for x, y in terms]
        acc = 0.0 if init is None else init.numpy().astype(np.float64)
        for x, y, k in seq:
            acc = _rz(acc + x[..., k:k + 8] @ y[..., k:k + 8, :])
        total = acc if total is None else (total + acc).astype(
            np.float32).astype(np.float64)
    return torch.from_numpy(total.astype(np.float32))


def test_kernel_order_holds_the_tolerance_under_round_toward_zero():
    q, k, v, do, lse, di, scale = _inputs(False, h=1)
    want = _backward(*(t.double() for t in (q, k, v, do, lse, di)), False,
                     scale, torch.matmul)
    errs = {}
    for kernel_order in (True, False):
        def mm(a, b):
            # dK, dV, dQ reduce over rows in steps of 32 (f32 dkv's query
            # tiles, dq's key tiles at D = 64); S and dP over d in one go
            step = 32 if a.shape[-1] == q.shape[-2] else None
            return _mm_rz(a, b, kernel_order, step)
        got = _backward(q, k, v, do, lse, di, False, scale, mm)
        errs[kernel_order] = [float((g.double() - r).abs().max())
                              for g, r in zip(got, want)]
    for i, (name, ref) in enumerate(zip(('dq', 'dk', 'dv'), want)):
        tol = fa.grad_tolerance(ref.float())
        assert errs[True][i] <= tol / 4, (name, errs[True][i], tol)
        assert errs[False][i] > 3 * errs[True][i], (name, errs)


def _forward(q, k, v, causal, scale, mm_s, pv, bk=64):
    """softmax(scale·q·kᵀ)·v in the forward kernel's order of work: tiles of
    bk keys, S = mm_s(q, kᵀ) scaled into the log2 domain in f32, the
    running max m and sum l of each row, O rescaled by exp2(m_old - m_new)
    and then O = pv(O, P, v_tile); O / l at the end. A row with no key kept
    so far takes m = 0 for its p, as the kernel's guard does."""
    sq, sk = q.shape[-2], k.shape[-2]
    scale_log2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    m = torch.full(q.shape[:-1], float('-inf'))
    l = torch.zeros(q.shape[:-1])
    out = torch.zeros(q.shape)
    rows = torch.arange(sq)[:, None]
    for n0 in range(0, sk, bk):
        k_t, v_t = k[..., n0:n0 + bk, :], v[..., n0:n0 + bk, :]
        s = mm_s(q, k_t.transpose(-1, -2).contiguous()) * scale_log2
        if causal:
            keys = torch.arange(n0, n0 + k_t.shape[-2])[None, :]
            s = s.masked_fill(keys > rows + sk - sq, float('-inf'))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == float('-inf'), torch.zeros(()), m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * alpha + p.sum(-1)
        out = pv(out * alpha[..., None], p, v_t)
        m = m_new
    return out / l[..., None]


@pytest.mark.parametrize('causal', [False, True])
def test_forward_kernel_order_holds_the_f32_tolerance(causal):
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 512, 64).astype(np.float32))
               for _ in range(3))
    scale = 0.125
    want = fa.flash_attention_reference(q.double(), k.double(), v.double(),
                                        causal, scale)
    tol = fa.tolerance(v)
    variants = {
        # S in the kernel order; each tile's P V in a fresh partial
        'kernel': (lambda a, b: _mm_rz(a, b, True),
                   lambda o, p, v_t: o + _mm_rz(p, v_t, True)),
        # three mma per k, and P V accumulated into O itself
        'plain_order': (lambda a, b: _mm_rz(a, b, False),
                        lambda o, p, v_t: _mm_rz(p, v_t, False, init=o)),
        # one TF32 product, no split
        'tf32': (lambda a, b: _mm(a, b, 1),
                 lambda o, p, v_t: o + _mm(p, v_t, 1)),
    }
    err = {}
    for name, (mm_s, pv) in variants.items():
        got = _forward(q, k, v, causal, scale, mm_s, pv)
        err[name] = float((got.double() - want).abs().max())
    assert err['kernel'] <= tol / 10, (err, tol)
    assert err['plain_order'] > 2 * err['kernel'], (err, tol)
    assert err['tf32'] > 3 * tol, (err, tol)
