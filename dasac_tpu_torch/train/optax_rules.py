"""optax's optimizers by name (``MODEL.OPT``), the port's own copy of
optax 0.2.6's rules (``optax/_src/alias.py``, ``transform.py``,
``factorized.py``, ``transforms/``).

``dasac_tpu`` builds each of its four LR groups as
``optax.chain(add_decayed_weights(wd), getattr(optax, name)(lr))``
(``wd`` on the weight groups only) at optax's defaults, and
``optax.apply_updates`` adds the result to the parameters.
:class:`OptaxRule` computes the same thing over the port's param groups
(``train/optim.py``): the group's coupled decay ``g + wd * p`` first, then
the rule, then ``p + u``.  A rule's own decay (``adamw``, ``adamaxw`` and
``nadamw``: 1e-4; ``lion``: 1e-3) acts on every parameter of its group,
biases included, and is scaled by the group's LR, as optax's is (its mask
is None).  Decays whose default is 0 (``adan``, ``lamb``, ``lars``,
``novograd``, ``adadelta``) add ``0 * p``, which changes no finite number:
they are left out.

Precision follows optax's: the step count is an int32 (one per parameter,
``state[p]["step"]``, on the host), and the scalars optax computes from it
in f32 (bias corrections ``1 - b ** t``, ``radam``'s rectification,
``adafactor``'s decay schedule, ``noisy_sgd``'s noise scale, ``fromage``'s
LR multiplier) are computed here in numpy f32 (:func:`_f32`).  In double,
0.999 differs from f32(0.999) by 1.3e-5 relative in ``1 - b2``, enough to
move a weight of the 20x group past 1e-6 in a few steps.

Layout: flax keeps conv kernels HWIO, the port OIHW (``nn/convert.py``).
The elementwise rules and the per-tensor norms (``lars``, ``lamb``,
``fromage``, ``novograd``, ``adafactor``'s clip and parameter scale) do not
see it.  ``adafactor`` factors its second moment over the two axes that
``np.argsort`` picks from the flax shape, and ``sm3`` keeps one
accumulator per axis: both take the flax axes mapped onto the port's
through :data:`FLAX_AXES`, and keep their state in the port's layout
(``adafactor``'s ``v_row`` is the port tensor with the port's image of
optax's ``d0`` removed; ``sm3``'s ``acc{k}`` belongs to the port's axis
``k``).  Every rank of a data or gspmd world holds whole parameters, so
every norm is a whole tensor's on every rank.

Every rule runs over lists of tensors (``torch._foreach_*``), the
per-tensor norms (``torch._foreach_norm`` on the card) and ``rprop``'s
selections (0/1 masks from a sign) included, but for the two whose
reductions follow each tensor's own axes: ``adafactor``'s factored moments
and ``sm3``'s accumulators loop over tensors.

``noisy_sgd``'s noise is drawn by :meth:`OptaxRule.sample_noise_draws`
(one standard normal tensor a parameter, param groups in order) and taken
by ``step(noise=...)``; without it the step draws from a generator seeded
from the optimizer's ``seed`` and the step count, so the same seed draws
the same noise on every rank and after a resume.
"""

import math

import numpy as np
import torch

# the port's axis of each flax axis: flax kernels are HWIO, the port's are
# OIHW (np.transpose(kernel, (3, 2, 0, 1)) in nn/convert.py); 1-D tensors
# (biases, BN) are the same in both
FLAX_AXES = {4: (2, 3, 1, 0)}


def flax_axes(ndim):
    """``axes[j]`` is the port's axis that holds flax's axis ``j``."""
    return FLAX_AXES.get(ndim, tuple(range(ndim)))


def _f32(x):
    return np.float32(x)


def _pow32(base, exponent):
    return np.power(_f32(base), _f32(exponent), dtype=np.float32)


def _bc(decay, t):
    """optax's bias correction ``1 - decay ** t`` (int32 ``t``), in f32."""
    return float(_f32(1) - _pow32(decay, t))


def _moment(bufs, grads, decay):
    """``buf = (1 - decay) * g + decay * buf`` in place."""
    torch._foreach_mul_(bufs, decay)
    torch._foreach_add_(bufs, grads, alpha=1.0 - decay)


def _moment2(bufs, grads, decay):
    """``buf = (1 - decay) * g ** 2 + decay * buf`` in place."""
    torch._foreach_mul_(bufs, decay)
    torch._foreach_addcmul_(bufs, grads, grads, value=1.0 - decay)


def _l2(xs):
    """The L2 norm of every tensor of ``xs``, a list of 0-d tensors: one
    ``torch._foreach_norm`` on the card; on the CPU a pairwise sum of
    squares a tensor, since torch's CPU norm accumulates in f32 in order
    (a relative error of ~4e-5 over 2M normal values, against ~1e-7)."""
    if xs[0].device.type == "cpu":
        return [torch.sqrt(torch.sum(x * x)) for x in xs]
    return list(torch._foreach_norm(xs))


def _norms(xs, min_norm=0.0):
    """optax's ``numerics.safe_norm`` of every tensor of ``xs`` (its whole
    L2 norm, ``min_norm`` where it is at most that), one 1-D tensor."""
    return torch.stack(_l2(xs)).clamp_min(min_norm)


def _block_rms(xs, min_rms=0.0):
    """The root mean square of every tensor of ``xs``, at least
    ``min_rms`` (optax's ``numerics.safe_root_mean_squares``), a list of
    0-d tensors."""
    r = _l2(xs)
    torch._foreach_div_(r, [math.sqrt(x.numel()) for x in xs])
    torch._foreach_clamp_min_(r, min_rms)
    return r


def _trust_ratio(updates, params, min_norm=0.0, coef=1.0, eps=0.0):
    """optax's ``scale_by_trust_ratio``: a new list."""
    pn, un = _norms(params, min_norm), _norms(updates, min_norm)
    ratio = coef * pn / (un + eps)
    ratio = torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(ratio),
                        ratio)
    return torch._foreach_mul(updates, ratio.unbind())


# ----------------------------------------------------------------------------
# the rules.  Each takes the group's context and returns ``(x, alpha)``: the
# step adds ``alpha * x`` to the parameters.  ``c.g`` are the gradients after
# the group's coupled decay, ``c.s[field]`` the state tensors, ``c.t`` the
# step count after this step's increment, ``c.lr`` the group's LR.
# ----------------------------------------------------------------------------


class _Ctx:
    __slots__ = ("p", "g", "s", "t", "lr", "noise")

    def __init__(self, p, g, s, t, lr, noise):
        self.p, self.g, self.s, self.t, self.lr, self.noise = (
            p, g, s, t, lr, noise)


def _adam(c, b1=0.9, b2=0.999, eps=1e-8, nesterov=False):
    """``scale_by_adam``: the corrected ratio, a new list."""
    mu, nu, g, t = c.s["mu"], c.s["nu"], c.g, c.t
    _moment(mu, g, b1)
    _moment2(nu, g, b2)
    if nesterov:
        m_hat = torch._foreach_div(mu, _bc(b1, t + 1))
        torch._foreach_mul_(m_hat, b1)
        g_hat = torch._foreach_div(g, _bc(b1, t))
        torch._foreach_mul_(g_hat, 1.0 - b1)
        torch._foreach_add_(m_hat, g_hat)
    else:
        m_hat = torch._foreach_div(mu, _bc(b1, t))
    den = torch._foreach_div(nu, _bc(b2, t))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(m_hat, den)
    return m_hat


def _decayed(x, c, wd):
    torch._foreach_add_(x, c.p, alpha=wd)
    return x


def _adamw(nesterov):
    def rule(c):
        return _decayed(_adam(c, nesterov=nesterov), c, 1e-4), -c.lr
    return rule


def _nadam(c):
    return _adam(c, nesterov=True), -c.lr


def _lamb(c):
    return _trust_ratio(_adam(c, eps=1e-6), c.p), -c.lr


def _optimistic(x, c, alpha, beta):
    """``scale_by_optimistic_gradient``: ``(alpha + beta) x - beta prev``
    (``prev = x`` on the first step); keeps ``x`` as ``prev``."""
    prev = c.s["prev"]
    if c.t == 1:
        torch._foreach_copy_(prev, x)
    out = torch._foreach_mul(x, alpha + beta)
    torch._foreach_sub_(out, torch._foreach_mul(prev, beta))
    torch._foreach_copy_(prev, x)
    return out


def _optimistic_adam(c):
    # alpha = beta = the LR, then scale_by_learning_rate(1.0)
    return _optimistic(_adam(c, nesterov=True), c, c.lr, c.lr), -1.0


def _optimistic_adam_v2(c):
    return _optimistic(_adam(c, nesterov=True), c, 1.0, 1.0), -c.lr


def _optimistic_gd(c):
    return _optimistic(c.g, c, 1.0, 1.0), -c.lr


def _adabelief(c, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16):
    mu, nu, g, t = c.s["mu"], c.s["nu"], c.g, c.t
    _moment(mu, g, b1)
    err = torch._foreach_sub(g, mu)
    _moment2(nu, err, b2)
    torch._foreach_add_(nu, eps_root)
    x = torch._foreach_div(mu, _bc(b1, t))
    den = torch._foreach_div(nu, _bc(b2, t))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(x, den)
    return x, -c.lr


def _adadelta(c, rho=0.9, eps=1e-6):
    e_g, e_x, g = c.s["e_g"], c.s["e_x"], c.g
    _moment2(e_g, g, rho)
    x = torch._foreach_add(e_x, eps)
    torch._foreach_sqrt_(x)
    den = torch._foreach_add(e_g, eps)
    torch._foreach_sqrt_(den)
    torch._foreach_div_(x, den)
    torch._foreach_mul_(x, g)
    _moment2(e_x, x, rho)
    return x, -c.lr


def _adagrad(c, eps=1e-7):
    sos, g = c.s["sum_of_squares"], c.g
    torch._foreach_addcmul_(sos, g, g)
    # where(sos > 0, rsqrt(sos + eps), 0): sos >= its initial 0.1 > 0
    x = torch._foreach_add(sos, eps)
    torch._foreach_rsqrt_(x)
    torch._foreach_mul_(x, g)
    return x, -c.lr


def _adamax(c, b1=0.9, b2=0.999, eps=1e-8):
    mu, nu, g, t = c.s["mu"], c.s["nu"], c.g, c.t
    _moment(mu, g, b1)
    a = torch._foreach_abs(g)
    torch._foreach_add_(a, eps)
    torch._foreach_mul_(nu, b2)
    torch._foreach_maximum_(nu, a)
    x = torch._foreach_div(mu, _bc(b1, t))
    torch._foreach_div_(x, nu)
    return x


def _adamax_rule(c):
    return _adamax(c), -c.lr


def _adamaxw(c):
    return _decayed(_adamax(c), c, 1e-4), -c.lr


def _adan(c, b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8):
    m, v, n, prev, g, t = (c.s["m"], c.s["v"], c.s["n"], c.s["g"], c.g,
                           c.t)
    diff = ([torch.zeros_like(x) for x in g] if t == 1
            else torch._foreach_sub(g, prev))
    _moment(m, g, b1)
    _moment(v, diff, b2)
    sq = torch._foreach_mul(diff, 1.0 - b2)
    torch._foreach_add_(sq, g)
    _moment2(n, sq, b3)
    x = torch._foreach_div(m, _bc(b1, t))
    v_hat = torch._foreach_div(v, _bc(b2, t))
    torch._foreach_mul_(v_hat, 1.0 - b2)
    torch._foreach_add_(x, v_hat)
    den = torch._foreach_div(n, _bc(b3, t))
    torch._foreach_add_(den, eps_root)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(x, den)
    torch._foreach_copy_(prev, g)
    return x, -c.lr


def _amsgrad(c, b1=0.9, b2=0.999, eps=1e-8):
    mu, nu, nu_max, g, t = c.s["mu"], c.s["nu"], c.s["nu_max"], c.g, c.t
    _moment(mu, g, b1)
    _moment2(nu, g, b2)
    torch._foreach_maximum_(nu_max, torch._foreach_div(nu, _bc(b2, t)))
    x = torch._foreach_div(mu, _bc(b1, t))
    den = torch._foreach_sqrt(nu_max)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(x, den)
    return x, -c.lr


def _fromage(c, min_norm=1e-6):
    # optax: mult = 1 / sqrt(1 + lr ** 2) in f32; scale by -lr * mult, then
    # add (mult - 1) * p
    mult = _f32(1) / np.sqrt(_f32(1 + c.lr ** 2))
    x = _trust_ratio(c.g, c.p, min_norm=min_norm)
    torch._foreach_mul_(x, -float(_f32(c.lr) * mult))
    torch._foreach_add_(x, c.p, alpha=float(mult - _f32(1)))
    return x, 1.0


def _lars(c, coef=0.001, momentum=0.9):
    x = _trust_ratio(c.g, c.p, coef=coef)
    torch._foreach_mul_(x, -c.lr)
    tr = c.s["trace"]
    torch._foreach_mul_(tr, momentum)
    torch._foreach_add_(tr, x)
    return tr, 1.0


def _lion(c, b1=0.9, b2=0.99, wd=1e-3):
    mu, g = c.s["mu"], c.g
    # sign((1 - b1) g + b1 mu): both products rounded, as optax's
    x = torch._foreach_mul(g, 1.0 - b1)
    torch._foreach_add_(x, torch._foreach_mul(mu, b1))
    torch._foreach_sign_(x)
    _moment(mu, g, b2)
    return _decayed(x, c, wd), -c.lr


def _noisy_sgd(c, eta=0.01, gamma=0.55):
    std = np.sqrt(_f32(eta) / _pow32(c.t, gamma))
    return torch._foreach_add(c.g, c.noise, alpha=float(std)), -c.lr


def _novograd(c, b1=0.9, b2=0.25, eps=1e-6):
    mu, nu, g = c.s["mu"], c.s["nu"], c.g
    sq = _l2(g)
    torch._foreach_mul_(sq, sq)  # optax: jnp.linalg.norm(g) ** 2
    if c.t == 1:
        torch._foreach_copy_(nu, sq)
    else:
        _moment(nu, sq, b2)
    den = torch._foreach_sqrt(nu)
    torch._foreach_add_(den, eps)
    x = torch._foreach_div(g, den)
    if c.t == 1:
        torch._foreach_copy_(mu, x)
    else:
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, x)
    return mu, -c.lr


def _radam(c, b1=0.9, b2=0.999, eps=1e-8, threshold=5.0):
    mu, nu, g, t = c.s["mu"], c.s["nu"], c.g, c.t
    _moment(mu, g, b1)
    _moment2(nu, g, b2)
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = _pow32(b2, t)
    ro = _f32(ro_inf) - _f32(2 * t) * b2t / (_f32(1) - b2t)
    x = torch._foreach_div(mu, _bc(b1, t))
    if ro >= threshold:
        r = np.sqrt((ro - _f32(4.0)) * (ro - _f32(2.0)) * _f32(ro_inf)
                    / (_f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        torch._foreach_mul_(x, float(r))
        den = torch._foreach_div(nu, _bc(b2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(x, den)
    return x, -c.lr


def _rmsprop(c, decay=0.9, eps=1e-8):
    nu, g = c.s["nu"], c.g
    _moment2(nu, g, decay)
    x = torch._foreach_add(nu, eps)
    torch._foreach_rsqrt_(x)
    torch._foreach_mul_(x, g)
    return x, -c.lr


def _select(mask, a, b):
    """``where(mask, a, b)`` for 0/1 ``mask`` lists, exactly: one of the
    two products is 0, the other ``a`` or ``b`` times 1."""
    out = torch._foreach_mul(a, mask)
    other = torch._foreach_neg(mask)
    torch._foreach_add_(other, 1.0)
    torch._foreach_add_(out, torch._foreach_mul(b, other))
    return out


def _rprop(c, eta_minus=0.5, eta_plus=1.2, lo=1e-6, hi=50.0):
    # optax's update is the PREVIOUS step's signed step size (zero where
    # the gradient changed sign), and it keeps this step's for the next.
    # s = g * prev is read through its sign: 0/1 masks of s > 0, s >= 0
    # and s != 0
    g, sizes, prev = c.g, c.s["step_sizes"], c.s["prev_updates"]
    sgn = torch._foreach_mul(g, prev)
    torch._foreach_sign_(sgn)
    grew = torch._foreach_clamp_min(sgn, 0.0)
    keep = torch._foreach_clamp_max(sgn, 0.0)
    torch._foreach_add_(keep, 1.0)  # s >= 0
    moved = torch._foreach_abs(sgn)
    grown = _select(grew, torch._foreach_mul(sizes, eta_plus),
                    torch._foreach_mul(sizes, eta_minus))
    torch._foreach_clamp_min_(grown, lo)
    torch._foreach_clamp_max_(grown, hi)
    torch._foreach_copy_(sizes, _select(moved, grown, sizes))
    x = torch._foreach_mul(prev, keep)
    new = torch._foreach_sign(g)
    torch._foreach_mul_(new, sizes)
    torch._foreach_mul_(new, keep)
    torch._foreach_copy_(prev, new)
    return x, -1.0


def _sign_sgd(c):
    return torch._foreach_sign(c.g), -c.lr


def _sm3(c, b1=0.9, eps=1e-8):
    x = []
    for g, st in zip(c.g, c.s["per_tensor"]):
        accs = [st["acc%d" % k] for k in range(g.ndim)]
        if g.ndim < 2:
            acc = g * g + accs[0]
        else:
            low = accs[0].reshape(_along(g.shape, 0))
            for k in range(1, g.ndim):
                low = torch.minimum(low, accs[k].reshape(_along(g.shape, k)))
            acc = g * g + low
        scale = torch.where(acc > 0, torch.rsqrt(acc + eps),
                            torch.zeros_like(acc))
        nu = st["nu"]
        nu.mul_(b1).add_(g * scale, alpha=1.0 - b1)
        if g.ndim < 2:
            accs[0].copy_(acc)
        else:
            for k in range(g.ndim):
                accs[k].copy_(torch.amax(
                    acc, dim=[a for a in range(g.ndim) if a != k]))
        x.append(nu)
    return x, -c.lr


def _along(shape, axis):
    return [1] * axis + [shape[axis]] + [1] * (len(shape) - axis - 1)


def _yogi(c, b1=0.9, b2=0.999, eps=1e-3):
    mu, nu, g, t = c.s["mu"], c.s["nu"], c.g, c.t
    _moment(mu, g, b1)
    g2 = torch._foreach_mul(g, g)
    d = torch._foreach_sub(nu, g2)
    torch._foreach_sign_(d)
    torch._foreach_mul_(d, 1.0 - b2)
    torch._foreach_mul_(d, g2)
    torch._foreach_sub_(nu, d)
    x = torch._foreach_div(mu, _bc(b1, t))
    den = torch._foreach_div(nu, _bc(b2, t))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(x, den)
    return x, -c.lr


def factored_dims(shape, min_dim=128):
    """optax's ``_factored_dims`` on the flax shape of a port tensor of
    ``shape``, mapped to the port's axes: ``(d1, d0)`` (optax's names: the
    second largest and the largest axis), or None."""
    if len(shape) < 2:
        return None
    axes = flax_axes(len(shape))
    fshape = [shape[k] for k in axes]
    order = np.argsort(fshape)
    if fshape[order[-2]] < min_dim:
        return None
    return axes[int(order[-2])], axes[int(order[-1])]


def _adafactor(c, decay=0.8, eps=1e-30, clip=1.0, min_scale=1e-3):
    # decay_rate_pow(step) = 1 - (step + 1) ** -0.8 with step the count
    # before this step's increment, in f32
    d = _f32(1) - _pow32(c.t, -decay)
    d, e = float(d), float(_f32(1) - d)
    states = c.s["per_tensor"]
    x = [None] * len(c.g)
    # the unfactored moments over the list
    flat = [i for i, st in enumerate(states) if "v" in st]
    if flat:
        g = [c.g[i] for i in flat]
        v = [states[i]["v"] for i in flat]
        g2 = torch._foreach_mul(g, g)
        torch._foreach_add_(g2, eps)
        torch._foreach_mul_(v, d)
        torch._foreach_add_(v, g2, alpha=e)
        u = torch._foreach_pow(v, -0.5)
        torch._foreach_mul_(u, g)
        for i, ui in zip(flat, u):
            x[i] = ui
    # the factored ones tensor by tensor: their axes differ
    for i, (p, g, st) in enumerate(zip(c.p, c.g, states)):
        if "v" in st:
            continue
        g2 = g * g + eps
        d1, d0 = factored_dims(p.shape)
        row, col = st["v_row"], st["v_col"]
        row.mul_(d).add_(g2.mean(dim=d0), alpha=e)
        col.mul_(d).add_(g2.mean(dim=d1), alpha=e)
        r1 = d1 - 1 if d1 > d0 else d1
        row_f = (row / row.mean(dim=r1, keepdim=True)).pow(-0.5)
        x[i] = g * row_f.unsqueeze(d0) * col.pow(-0.5).unsqueeze(d1)
    # clip_by_block_rms(1.0), scale by the LR, by the parameter's RMS
    den = _block_rms(x)
    torch._foreach_div_(den, clip)
    torch._foreach_clamp_min_(den, 1.0)
    torch._foreach_div_(x, den)
    torch._foreach_mul_(x, c.lr)
    torch._foreach_mul_(x, _block_rms(c.p, min_scale))
    return x, -1.0


# ----------------------------------------------------------------------------
# name -> (rule, initial state of one parameter)
# ----------------------------------------------------------------------------

def _zeros(*names):
    return lambda p, lr: {n: torch.zeros_like(p) for n in names}


def _sm3_init(p, lr):
    st = {"acc%d" % k: p.new_zeros(p.shape[k]) for k in range(p.ndim)}
    st["nu"] = torch.zeros_like(p)
    return st


def _adafactor_init(p, lr):
    dims = factored_dims(p.shape)
    if dims is None:
        return {"v": torch.zeros_like(p)}
    d1, d0 = dims
    shape = list(p.shape)
    return {"v_row": p.new_zeros(shape[:d0] + shape[d0 + 1:]),
            "v_col": p.new_zeros(shape[:d1] + shape[d1 + 1:])}


RULES = {
    "adabelief": (_adabelief, _zeros("mu", "nu")),
    "adadelta": (_adadelta, _zeros("e_g", "e_x")),
    "adafactor": (_adafactor, _adafactor_init),
    "adagrad": (_adagrad,
                lambda p, lr: {"sum_of_squares": torch.full_like(p, 0.1)}),
    "adamax": (_adamax_rule, _zeros("mu", "nu")),
    "adamaxw": (_adamaxw, _zeros("mu", "nu")),
    "adamw": (_adamw(False), _zeros("mu", "nu")),
    "adan": (_adan, _zeros("m", "v", "n", "g")),
    "amsgrad": (_amsgrad, _zeros("mu", "nu", "nu_max")),
    "fromage": (_fromage, _zeros()),
    "lamb": (_lamb, _zeros("mu", "nu")),
    "lars": (_lars, _zeros("trace")),
    "lion": (_lion, _zeros("mu")),
    "nadam": (_nadam, _zeros("mu", "nu")),
    "nadamw": (_adamw(True), _zeros("mu", "nu")),
    "noisy_sgd": (_noisy_sgd, _zeros()),
    "novograd": (_novograd,
                 lambda p, lr: {"mu": torch.zeros_like(p),
                                "nu": p.new_zeros(())}),
    "optimistic_adam": (_optimistic_adam, _zeros("mu", "nu", "prev")),
    "optimistic_adam_v2": (_optimistic_adam_v2, _zeros("mu", "nu", "prev")),
    "optimistic_gradient_descent": (_optimistic_gd, _zeros("prev")),
    "radam": (_radam, _zeros("mu", "nu")),
    "rmsprop": (_rmsprop, _zeros("nu")),
    "rprop": (_rprop, lambda p, lr: {"step_sizes": torch.full_like(p, lr),
                                     "prev_updates": torch.zeros_like(p)}),
    "sign_sgd": (_sign_sgd, _zeros()),
    "sm3": (_sm3, _sm3_init),
    "yogi": (_yogi, lambda p, lr: {"mu": torch.full_like(p, 1e-6),
                                   "nu": torch.full_like(p, 1e-6)}),
}

NAMES = tuple(sorted(RULES))
# rules whose update is a sign: f32 rounding near 0 may flip an element
SIGN_RULES = ("lion", "rprop", "sign_sgd")
# rules whose fields differ from tensor to tensor: their state goes to the
# rule tensor by tensor (``c.s["per_tensor"]``)
_PER_TENSOR = ("adafactor", "sm3")


def _fold(seed, t):
    return (seed * 1_000_003 + t) % (2 ** 63 - 1)


class OptaxRule(torch.optim.Optimizer):
    """One of optax's optimizers (``name`` in :data:`NAMES`) over param
    groups that each carry ``lr`` and ``weight_decay`` (the chain's coupled
    decay).  The state of a parameter is created at its first step:
    ``step`` (int32 on the host) and the rule's tensors on the parameter's
    device.  ``seed``: ``noisy_sgd``'s draws when the step is given
    none."""

    def __init__(self, params, name, seed=0):
        if name not in RULES:
            raise ValueError("no optax rule named %r" % (name,))
        self.rule, self._init = RULES[name]
        self.name, self.seed = name, int(seed)
        super().__init__(params, dict(lr=1e-3, weight_decay=0.0))

    def init_state(self, p, group):
        """The state of ``p`` before its first step."""
        st = self._init(p.detach(), float(group["lr"]))
        st["step"] = torch.zeros((), dtype=torch.int32)
        return st

    def sample_noise_draws(self, generator):
        """``noisy_sgd``'s draws for one step: a standard normal tensor like
        each parameter, param groups in order."""
        return [[torch.randn(p.shape, generator=generator, device=p.device,
                             dtype=p.dtype) for p in g["params"]]
                for g in self.param_groups]

    def _own_noise(self, t):
        p0 = self.param_groups[0]["params"][0]
        gen = torch.Generator(device=p0.device)
        gen.manual_seed(_fold(self.seed, t))
        return self.sample_noise_draws(gen)

    @torch.no_grad()
    def step(self, closure=None, noise=None):
        """One step of every group.  ``noise`` (``noisy_sgd``): the draws
        of :meth:`sample_noise_draws`."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for gi, group in enumerate(self.param_groups):
            params = group["params"]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(self.init_state(p, group))
            states = [self.state[p] for p in params]
            steps = [s["step"] for s in states]
            t = int(steps[0]) + 1
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            wd = group["weight_decay"]
            if wd > 0:
                grads = torch._foreach_add(grads, params, alpha=wd)
            if self.name in _PER_TENSOR:
                s = {"per_tensor": states}
            else:
                s = {k: [st[k] for st in states] for k in states[0]
                     if k != "step"}
            if self.name == "noisy_sgd":
                if noise is None:
                    noise = self._own_noise(t)
                draws = noise[gi]
            else:
                draws = None
            x, alpha = self.rule(_Ctx(params, grads, s, t,
                                      float(group["lr"]), draws))
            torch._foreach_add_(params, x, alpha=alpha)
            torch._foreach_add_(steps, 1)
        return loss
