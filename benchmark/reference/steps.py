"""The reference's train steps and inference, in plain PyTorch.

``Algo`` holds the hyperparameters, read from the configuration keys the
benchmark hands to both sides (``cfg``: the YAML schema's dotted keys).
The steps follow the reference trainer (train.py:130-233, 273-289) in the
order the port runs them, so that the draws of one generator feed the
same augmentation and dropout on both sides."""

import torch
from torch.func import functional_call

from benchmark.reference import aug, sac
from benchmark.reference.archs import load as load_arch
from benchmark.reference.layers import init_spec, resize_align_corners
from benchmark.reference.layers import resize_linear

LR_MULT = {"old_w": 1.0, "old_b": 2.0, "new_w": 10.0, "new_b": 20.0}


class Algo:
    """The step's hyperparameters from the dotted keys of ``cfg``."""

    def __init__(self, cfg):
        g = cfg.__getitem__
        self.arch = g("MODEL.ARCH")
        self.crop = tuple(g("DATASET.CROP_SIZE"))
        self.group_size = g("TRAIN.GROUP_SIZE")
        self.lr, self.wd = g("MODEL.LR"), g("MODEL.WEIGHT_DECAY")
        self.momentum = g("MODEL.MOMENTUM")
        self.lr_target = g("MODEL.LR_TARGET")
        self.net_momentum = g("MODEL.NET_MOMENTUM")
        self.net_momentum_iter = g("MODEL.NET_MOMENTUM_ITER")
        self.stat_momentum = g("MODEL.STAT_MOMENTUM")
        self.beta = g("MODEL.THRESHOLD_BETA")
        self.upper = g("MODEL.RUN_CONF_UPPER")
        self.lower = g("MODEL.RUN_CONF_LOWER")
        self.focal_p = g("MODEL.FOCAL_P")
        self.use_conf = g("MODEL.LOSS") == "focal_ce_conf"
        self.mean, self.std = tuple(g("DATASET.MEAN")), tuple(g("DATASET.STD"))
        if g("DATASET.RENORM_SOURCE"):
            self.src_mean, self.src_std = aug.renorm_stats(
                self.mean, self.std, g("DATASET.SOURCE_MEAN"),
                g("DATASET.SOURCE_STD"), g("DATASET.TARGET_MEAN"),
                g("DATASET.TARGET_STD"))
        else:
            self.src_mean, self.src_std = self.mean, self.std
        # the reference's quirk: gated by SRC_RND_JITTER, strength RND_JITTER
        self.src = dict(
            crop_hw=self.crop,
            scale_range=(g("DATASET.SCALE_FROM"), g("DATASET.SCALE_TO")),
            hflip=g("DATASET.RND_HFLIP"),
            jitter=g("DATASET.RND_JITTER") if g("DATASET.SRC_RND_JITTER") > 0
            else 0.0, blur=g("DATASET.SRC_RND_BLUR"))
        self.tgt = dict(
            group_size=self.group_size,
            target_scale=tuple(g("DATASET.TARGET_SCALE")),
            zoom=tuple(g("DATASET.RND_ZOOM")),
            group_hflip=g("DATASET.RND_HFLIP"),
            guided_hflip=g("DATASET.GUIDED_HFLIP"), blur=g("DATASET.RND_BLUR"),
            jitter=g("DATASET.RND_JITTER"),
            greyscale=g("DATASET.RND_GREYSCALE"),
            mean=self.mean, std=self.std)


def build_model(arch, num_classes, weights, device, **kw):
    """The reference model of ``arch`` holding ``weights`` (a state dict)
    on ``device``, its tensors in float32."""
    with torch.device("meta"):
        model = load_arch(arch).Model(num_classes, **kw)
    model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def init_specs(arch, num_classes, **kw):
    """``layers.init_spec`` of ``arch``'s model, built on the meta device."""
    with torch.device("meta"):
        return init_spec(load_arch(arch).Model(num_classes, **kw))


def build_sgd(model, algo):
    """torch SGD over the reference's four groups: pretrained weights 1x
    with decay, their biases 2x without, from-scratch weights 10x with
    decay, their biases 20x without."""
    scopes = load_arch(algo.arch).NEW_SCOPES
    groups = {k: [] for k in LR_MULT}
    for name, p in model.named_parameters():
        new = any(name == s or name.startswith(s + ".") for s in scopes)
        bias = name.rsplit(".", 1)[-1] == "bias"
        groups[("new_" if new else "old_") + ("b" if bias else "w")].append(p)
    return torch.optim.SGD(
        [dict(params=ps, lr=algo.lr * LR_MULT[k],
              weight_decay=0.0 if k.endswith("_b") else algo.wd)
         for k, ps in groups.items()], lr=algo.lr, momentum=algo.momentum)


class TrainState:
    """The model, its SGD, the teacher's tensors by name, the class prior
    and the counters."""

    def __init__(self, model, algo, num_classes):
        self.model, self.algo = model, algo
        self.opt = build_sgd(model, algo)
        self.teacher = {k: v.detach().clone()
                        for k, v in self._student().items()}
        self.running_conf = torch.zeros(num_classes, device=next(
            model.parameters()).device)
        self.slow_init, self.step = 0, 0

    def _student(self):
        out = dict(self.model.named_parameters())
        out.update({k: v for k, v in self.model.named_buffers()
                    if v.is_floating_point()})
        return out


def sac_step(st, batch, generator, prec):
    """One SAC step on the loader-size batch ``(src_images, src_labels,
    tgt_images, tgt_labels)``; returns the two losses."""
    a, model = st.algo, st.model
    src_images, src_labels, tgt_images, tgt_labels = batch
    src, src_lbl = aug.source_batch(generator, src_images, src_labels,
                                    mean=a.src_mean, std=a.src_std, **a.src)
    views = aug.target_groups(generator, tgt_images, tgt_labels, **a.tgt)
    do_update = st.step % a.net_momentum_iter == 0 or not st.slow_init
    student = st._student()
    names = list(st.teacher)
    st.slow_init, rc = sac.update_teacher(
        [st.teacher[k] for k in names], [student[k].detach() for k in names],
        st.slow_init, st.running_conf, momentum=a.net_momentum, beta=a.beta,
        do_update=do_update)
    with torch.no_grad():
        t_logits, _ = functional_call(model, st.teacher, (views.frames_clean,
                                                          prec))
        refined, t_probs = sac.refine_stride8(
            t_logits, views.affine, views.affine_inv, views.padding,
            a.group_size, prec.refine)
        rc = sac.update_running_conf(rc, t_probs, a.stat_momentum, a.beta)
        pseudo, conf = sac.pseudo_labels(
            refined, views.padding, rc, upper=a.upper, lower=a.lower,
            beta=a.beta, dtype=prec.refine or torch.float32)
        del t_logits, refined, t_probs
    st.opt.zero_grad(set_to_none=True)
    _, up = model(src, prec, train=True, generator=generator)
    ce_src = sac.cross_entropy_mean(up, src_lbl)
    ce_src.backward()
    del up
    _, up = model(views.frames_aug, prec, train=True, generator=generator)
    self_ce = sac.focal_ce(up, pseudo, conf, rc, p=a.focal_p,
                           use_conf=a.use_conf)
    (a.lr_target * self_ce).backward()
    del up
    st.opt.step()
    st.running_conf = rc
    st.step += 1
    return {"src_loss_ce": ce_src.detach(), "self_ce": self_ce.detach()}


def abn_step(st, batch, generator, prec):
    """One ABN step: the source CE with live BN, its backward and the SGD
    step, then a no-grad target pass on the updated model that refreshes
    the BN statistics.  Both halves go through the source pipeline."""
    a, model = st.algo, st.model
    src_images, src_labels, tgt_images, tgt_labels = batch
    src, src_lbl = aug.source_batch(generator, src_images, src_labels,
                                    mean=a.src_mean, std=a.src_std, **a.src)
    tgt, tgt_lbl = aug.source_batch(generator, tgt_images, tgt_labels,
                                    mean=a.mean, std=a.std, **a.src)
    st.opt.zero_grad(set_to_none=True)
    _, up = model(src, prec, live=True, train=True, generator=generator)
    ce_src = sac.cross_entropy_mean(up, src_lbl)
    ce_src.backward()
    del up
    st.opt.step()
    with torch.no_grad():
        _, up = model(tgt, prec, live=True, train=True, generator=generator)
        ce_tgt = sac.cross_entropy_mean(up, tgt_lbl)
    st.step += 1
    return {"src_loss_ce": ce_src.detach(), "loss_ce": ce_tgt}


@torch.no_grad()
def infer_probs(model, images_u8, prec, *, mean, std, scales, flip):
    """The multi-scale protocol: each scale's normalized, linearly resized
    frame (and its mirror) through the model, the upsampled logits
    resized to the frame (align corners), softmaxed there, the mirror's
    mirrored back, all averaged.  Returns f32 [B, H, W, C]."""
    x = aug.normalize(images_u8.float() / 255.0, mean, std)
    b, h, w = x.shape[:3]
    acc = None
    for s in scales:
        xs = x if s == 1.0 else resize_linear(
            x, (int(round(h * s)), int(round(w * s))))
        if flip:
            xs = torch.cat([xs, xs.flip(2)], 0)
        _, up = model(xs, prec)
        p = torch.softmax(resize_align_corners(up, (h, w)), dim=-1)
        if flip:
            p = p[:b] + p[b:].flip(2)
        acc = p if acc is None else acc + p
    return acc / (len(scales) * (2 if flip else 1))
