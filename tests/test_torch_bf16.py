"""bfloat16 in the torch port, against the reference in bfloat16 and
float64 truth, on the CPU.

The standard (pathintegralgroundstate_torch/utils/bf16.py): a bfloat16
result x of a plain form is held to float64 truth x64, the float64 plain
form on the same bfloat16 inputs, by |x - x64| <= C 2^-8 sum|terms|, each
pair term counted with its sensitivity to the rounding of its inputs, and
x non-finite exactly where x64 is.  Bitwise equality of the two packages
is not the standard: single operations agree bitwise between jnp and torch
in bfloat16, but the order of the operations inside a formula decides the
rounding.  C = 8 is fixed from the reference's own jnp forms in bfloat16
(delta_action_rows, pair_pot, delta_pot, delta_wf, cascade_jnp) on the
cases below, whose worst ratio was 2.35 (the dipolar gas at D = 4, raw
dpot; the port's plain forms: 2.35 too), and from the port's plain forms
on the card's liquid paths (worst 4.23, D = 1); every plain form of
both packages is held to it per pair model at D = 1 to 4.  The kernels on the
card are held to the same C against their plain forms' float64 truth
(tests/test_torch_cuda.py::test_kernels_in_bfloat16_within_the_bound:
worst ratio about 1).  Kernel 5's positions are held
by C 2^-8 (|x64| + |xold| + sqrt(L dt) max|g|) where both accept, its
decisions agreeing with float64 truth on at least 3/4 of the slots here
(16 walkers) and more than 90 % on the card.

The draws follow the reference's bfloat16 law (utils/draws): uniforms k/128
with k uniform on 0..127, Gaussians sqrt(2) erfinv on 128 levels, the
swap's Gumbel noise on the same 128 uniforms; the statistics accumulate in
float32 (a block of 320 diagonal walker-steps counts them all, where a
bfloat16 count stops at 256), the StepStats dtypes are the reference's, and
the 1-D oscillator with its exact trial wave function gives <E> = 0.5
within the bfloat16 error of its local energy in both packages.  The
state crosses between the packages exactly (bfloat16 through float32), and
a bfloat16 CLI run of 2 blocks equals 1 block, a resume and 1 more block,
bitwise.
"""

import contextlib
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps
from torch_bridge import lattice_paths, other_cfg, small_cfg, tt

from pathintegralgroundstate_torch import cli
from pathintegralgroundstate_torch import sweep as tsweep
from pathintegralgroundstate_torch.config import namelist_text
from pathintegralgroundstate_torch.ops import cascade as cas
from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.ops.pairwise import chin_table
from pathintegralgroundstate_torch.state import init_state, \
    state_from_numpy, state_to_numpy
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils import bf16 as B
from pathintegralgroundstate_torch.utils.draws import DeviceDraws, \
    bf16_normal_table
from pathintegralgroundstate_tpu import sweep as jsweep
from pathintegralgroundstate_tpu.ops import cascade_kernels as jcas
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.state import init_state as j_init_state
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

BF = torch.bfloat16
MODELS = [("aziz2", "mcmillan_c1"), ("soft", "dipolar2d"),
          ("dipolar", "dipolar2d"), ("none", "mcmillan")]
DENSITY = {1: 0.5, 2: 0.26, 3: 0.365, 4: 0.365}
FORMS = ["rows", "pot", "dense", "u", "cascade"]


def _ids(m):
    return "-".join(m)


def _cfgs(model, dim, **kw):
    """(float64 reference cfg, bfloat16 reference cfg)."""
    cfg = small_cfg(dim=dim, Np=16, n_walkers=4, density=DENSITY[dim],
                    potential=model[0], jastrow=model[1], **kw)
    return cfg, dataclasses.replace(cfg, dtype="bfloat16")


def _bf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF)


def _jx(t):
    """A bfloat16 torch tensor as a bfloat16 jax array (through float32)."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np64(x):
    return torch.from_numpy(np.asarray(x).astype(np.float64))


def _ratios(model, dim, form):
    """{package: worst ratio} of one plain form of both packages against
    float64 truth on one bfloat16 input block."""
    cfg, cb = _cfgs(model, dim, fused_sweep=True, cascade=True)
    t64 = make_system(other_cfg(cfg), "cpu")
    tb = make_system(other_cfg(cb), "cpu")
    jb = j_make_system(cb)
    tab_j = make_tables(jb)
    paths = lattice_paths(cfg, seed=3)
    W, M, N, D = paths.shape
    rng = np.random.default_rng(4)
    ip = rng.integers(0, N, (W, M))
    xold = np.take_along_axis(paths, ip[:, :, None, None], 2)[:, :, 0]
    xnew = xold + 0.1 * rng.normal(size=xold.shape)
    R, xn, xo = _bf(paths), _bf(xnew), _bf(xold)
    R64, xn64, xo64 = R.double(), xn.double(), xo.double()
    ipt = torch.from_numpy(ip)
    ib = torch.arange(M)
    jargs = (_jx(R), _jx(xn), _jx(xo), jnp.asarray(ip))
    out = {"jax": 0.0, "torch": 0.0}

    def held(name, j, t, truth, scale):
        for pkg, x in (("jax", j), ("torch", t)):
            out[pkg] = max(out[pkg], B.ratio(x, truth, scale))

    if form == "rows":
        for wf, f2 in ((True, True), (False, False)):
            held("rows",
                 _np64(jpw.delta_action_rows(jb, tab_j, *jargs,
                                             jnp.asarray(ib.numpy()),
                                             need_wf=wf, need_f2=f2)),
                 kernels.pair_rows_ref(tb, R, xn, xo, ipt, chin_table(tb),
                                       ib, wf, f2),
                 kernels.pair_rows_ref(t64, R64, xn64, xo64, ipt,
                                       chin_table(t64), ib, wf, f2),
                 B.rows_scale(t64, R64, xn64, xo64, ipt, chin_table(t64),
                              ib, wf, f2))
    elif form == "pot":
        for wf in (False, True):
            js = jpw.pair_pot(jb, tab_j, _jx(R), wf)
            ts = kernels.pair_pot_ref(tb, R, wf)
            truth = kernels.pair_pot_ref(t64, R64, wf)
            scale = B.pot_scale(t64, R64, wf)
            for i in range(1 + wf):
                held("pot", _np64(js[i]), ts[i], truth[i], scale[i])
    elif form == "dense":
        for wf in (False, True):
            js = jpw.delta_pot(jb, tab_j, *jargs, with_force=wf)
            ts = kernels.pair_delta_ref(tb, R, xn, xo, ipt, wf)
            truth = kernels.pair_delta_ref(t64, R64, xn64, xo64, ipt, wf)
            scale = B.dense_scale(t64, R64, xn64, xo64, ipt, wf)
            for i in range(1 + wf):
                held("dense", _np64(js[i]), ts[i], truth[i], scale[i])
    elif form == "u":
        held("u", _np64(jpw.delta_wf(jb, tab_j, *jargs)),
             kernels.pair_u_ref(tb, R, xn, xo, ipt),
             kernels.pair_u_ref(t64, R64, xn64, xo64, ipt),
             B.u_scale(t64, R64, xn64, xo64, ipt))
    else:
        held_cascade(cfg, t64, tb, jb, tab_j, paths, out)
    return out


def held_cascade(cfg, t64, tb, jb, tab_j, paths, out):
    """Kernel 5's plain forms in bfloat16 (cascade_jnp, cascade_ref)
    against cascade_ref in float64 on the same bfloat16 window and draws,
    both modes: decisions agreeing on at least 3/4 of the slots, and where
    both accept, the written positions within C 2^-8 (|x64| + |xold| +
    sqrt(L dt) max|g|), differences by the minimum image."""
    W, M, N, D = paths.shape
    nlev, L = 2, 4
    rng = np.random.default_rng(11)
    Lbox = t64.geo.Lbox[0]
    for mode in ("ends", "interior"):
        slots = ([(0, 1, 3), (M - 1, -1, 3)] if mode == "ends"
                 else [(2 + k * L, 1, p) for k, p in enumerate((1, 5))])
        S, G = len(slots), nlev + (mode == "ends")
        rg = _bf(0.6 * rng.normal(size=(W, S, L + 1, D)))
        ru = _bf(rng.uniform(size=(W, S, G)))
        act = torch.from_numpy(rng.uniform(size=(W, S)) < 0.9)
        p = _bf(paths)
        ref, got = p.double(), p.clone()
        acc64 = cas.cascade_ref(t64, mode, ref, slots, rg.double(),
                                ru.double(), act, nlev)
        acc_t = cas.cascade_ref(tb, mode, got, slots, rg, ru, act, nlev)
        Rwin = torch.stack([p[:, b0:b0 + L + 1] if st > 0 else
                            p[:, b0 - L:b0 + 1].flip(1)
                            for b0, st, _ in slots], 1)
        seg_j, acc_j = jcas.cascade_jnp(
            jb, tab_j, mode, _jx(Rwin), _jx(rg), _jx(ru),
            jnp.asarray([s[2] for s in slots], jnp.int32), nlev,
            jnp.asarray(act.numpy()))
        acc_j = torch.from_numpy(np.array(acc_j))
        seg_j = _np64(seg_j)
        sig = float(np.sqrt(L * cfg.dt)) * float(rg.double().abs().max())
        rows = slice(1, L) if mode == "interior" else slice(0, L + 1)
        for pkg, acc in (("jax", acc_j), ("torch", acc_t)):
            agree = acc == acc64
            assert float(agree.double().mean()) >= 0.75, (pkg, mode)
            for s, (b0, step, ip) in enumerate(slots):
                beads = (b0 + step * np.arange(L + 1))[rows]
                both = agree[:, s] & acc[:, s]
                x64 = ref[both][:, beads, ip]
                x = (seg_j[both][:, s, rows] if pkg == "jax"
                     else got[both][:, beads, ip].double())
                x = x64 + torch.remainder(x - x64 + 0.5 * Lbox,
                                          Lbox) - 0.5 * Lbox
                xo = p[both][:, beads, ip].double()
                out[pkg] = max(out[pkg], B.ratio(
                    x, x64, x64.abs() + xo.abs() + sig))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dim", [1, 2, 3, 4])
@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_plain_forms_within_the_bound(model, dim, form):
    """Both packages' bfloat16 plain form of each kernel within C 2^-8
    sum|terms| of float64 truth."""
    got = _ratios(model, dim, form)
    assert max(got.values()) <= B.C, got


# --- the draws ---------------------------------------------------------------

NDRAW = 1 << 16


def _port_draws(dtype="bfloat16"):
    system = make_system(other_cfg(small_cfg(dtype=dtype)), "cpu")
    return DeviceDraws(system, torch.Generator().manual_seed(5),
                       torch.Generator().manual_seed(6))


def test_bf16_uniforms_take_the_128_levels():
    """The port's uniforms are k/128, all 128 levels, uniformly (chi^2), as
    jax.random.uniform's in bfloat16 (whose support is the same set)."""
    u = _port_draws()._u(NDRAW)
    assert u.dtype == BF
    k = (u.double() * 128).numpy()
    assert np.array_equal(k, np.round(k)) and k.min() == 0 and k.max() == 127
    counts = np.bincount(k.astype(int), minlength=128)
    assert sps.chisquare(counts).pvalue > 1e-3
    ju = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (NDRAW,),
                                       jnp.bfloat16)).astype(np.float64)
    assert set(np.unique(ju)) == set(np.unique(k / 128))


def test_bf16_gaussians_follow_the_reference_law():
    """The port's Gaussians take exactly the 128 values of
    jax.random.normal in bfloat16 (bf16_normal_table), each with
    probability 1/128, and pass a two-sample KS test against the
    reference's draws."""
    table = bf16_normal_table("cpu")
    jg = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (NDRAW,),
                                      jnp.bfloat16)).astype(np.float64)
    assert set(np.unique(jg)) == set(table.double().numpy())
    assert len(set(table.double().numpy())) == 128
    g = _port_draws()._g(NDRAW)
    assert g.dtype == BF
    assert set(np.unique(g.double().numpy())) == set(np.unique(jg))
    assert sps.ks_2samp(g.double().numpy(), jg).pvalue > 1e-3


def test_bf16_swap_gumbel_takes_the_reference_values():
    """The swap's Gumbel noise -log(-log U) on the 128 uniforms, U = 0
    clamped to tiny: the 128 values of jax.random.gumbel in bfloat16."""
    src = _port_draws()
    sw = src.swap(0, NDRAW // 8, 8, 8)
    jg = np.asarray(jax.random.gumbel(jax.random.PRNGKey(3), (NDRAW,),
                                      jnp.bfloat16)).astype(np.float64)
    got = np.unique(sw.gumbel.double().numpy())
    assert set(got) <= set(np.unique(jg)) and len(got) == 128


def test_float32_draws_keep_torch_law():
    """float32 draws are torch.rand / torch.randn, as before."""
    src = _port_draws("float32")
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(src._u(64), torch.rand(64, generator=gen))


# --- statistics, state, oscillator, checkpoint -------------------------------

def test_bf16_block_counts_in_float32():
    """320 diagonal walker-steps (16 walkers, 20 steps, no worm) counted
    exactly, where a bfloat16 counter stops at 256; every StepStats field
    in the reference's zero_stats dtype for bfloat16."""
    cfg = small_cfg(dtype="bfloat16", n_walkers=16, CWorm=0.0, Nobdm=0,
                    swapping=False)
    system = make_system(other_cfg(cfg), "cpu")
    state, stats = tsweep.run_block(tsweep.Sweeper(system),
                                    init_state(system), 20)
    assert float(stats.n_diag) == 320.0 == float(stats.n_diag_all)
    want = jsweep.zero_stats(j_make_system(cfg))
    for k, v in stats._asdict().items():
        assert str(v.dtype).split(".")[1] == str(getattr(want, k).dtype), k
    assert state.paths.dtype == BF


def test_state_crosses_between_packages_exactly():
    """A bfloat16 reference state (ml_dtypes arrays) into the port and back
    out (float32 numpy) without a change; torch_bridge.tt reads bfloat16
    jax arrays."""
    cfg = small_cfg(dtype="bfloat16")
    jst = j_init_state(j_make_system(cfg))
    system = make_system(other_cfg(cfg), "cpu")
    st = state_from_numpy(system, {k: getattr(jst, k) for k in (
        "paths", "xend", "isopen", "iworm", "in_cycle", "iperm", "step")})
    assert st.paths.dtype == BF
    assert torch.equal(st.paths, tt(jst.paths))
    back = state_to_numpy(st)
    assert back["paths"].dtype == np.float32
    np.testing.assert_array_equal(
        back["paths"], np.asarray(jst.paths).astype(np.float32))
    again = state_from_numpy(system, back)
    assert torch.equal(again.paths, st.paths)
    assert torch.equal(again.xend, st.xend)


def _ho_cfg(**kw):
    """The verify recipe's 1-D oscillator with its exact trial wave
    function (E = 0.5 exactly in float64), in bfloat16."""
    return small_cfg(dim=1, Np=1, trap=True, dt=0.05, Nb=8, seed=1982,
                     delta_cm=0.5, CMFreq=1, sampling="sta", Lstag=8,
                     Nlev=2, Nstag=2, Nstep=10, Nbin=50, Nk=10,
                     swapping=False, CWorm=0.0, Nobdm=0, Npw=0, Rm=1.2,
                     a_ho=(1.0,), n_walkers=16, dtype="bfloat16",
                     potential="none", jastrow="mcmillan_c1", **kw)


# the local energy's largest term is dim Np / (2 dt) = 10: its bfloat16
# rounding, 10 2^-8, bounds <E>'s error
HO_TOL = 10 * 2.0 ** -8


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_bf16_oscillator_gives_a_half(package):
    cfg = _ho_cfg()
    if package == "jax":
        jsys = j_make_system(cfg)
        step = jax.jit(jsweep.Sweeper(jsys, make_tables(jsys)).step)
        st, stats = j_init_state(jsys), jsweep.zero_stats(jsys)
        for _ in range(10):
            st, stats = step(st, stats)
        e = float(stats.sumE) / float(stats.n_diag)
        assert stats.sumE.dtype == jnp.float32
    else:
        system = make_system(other_cfg(cfg), "cpu")
        _, stats = tsweep.run_block(tsweep.Sweeper(system),
                                    init_state(system), 10)
        e = float(stats.sumE) / float(stats.n_diag)
        assert stats.sumE.dtype == torch.float32
    assert abs(e - 0.5) <= HO_TOL, e


def test_bf16_checkpoint_resume_is_bitwise(tmp_path, monkeypatch):
    """A bfloat16 CLI run of 2 blocks == 1 block, a resume and 1 more block,
    to the last digit written and in every checkpoint array."""
    monkeypatch.setenv("PIGS_PLATFORM", "cpu")
    nml = tmp_path / "bf16.in"
    nml.write_text(namelist_text(small_cfg(dtype="bfloat16", Nstep=2,
                                           Nblock=2)))
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main([str(nml), "-o", one]) == 0
        assert cli.main([str(nml), "-o", two, "--blocks", "1"]) == 0
        assert cli.main([str(nml), "-o", two, "--set", "resume=T",
                         "--blocks", "1"]) == 0
    for name in ("e_vpi.out", "et_vpi.out", "gr_vpi.out"):
        with open(os.path.join(one, name)) as a, \
                open(os.path.join(two, name)) as b:
            assert a.read() == b.read(), name
    za = np.load(os.path.join(one, "checkpoint.npz"))
    zb = np.load(os.path.join(two, "checkpoint.npz"))
    assert za["paths"].dtype == np.float32
    for k in za.files:
        if k != "__config__":
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
