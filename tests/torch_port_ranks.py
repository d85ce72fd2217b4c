"""What the ranks of ``tests/test_torch_port_parallel.py`` and
``tests/test_torch_port_train.py`` run.  Spawned ranks import this module
by name, so it imports neither JAX nor the tests' JAX helpers."""

import numpy as np
import torch


def _group():
    from vts_torch.parallel.dist import DataGroup
    from vts_torch.platform import world
    w = world()
    return DataGroup(w.rank, w.size, w.group)


def ops_rank(bn, masked, sg2, skit, fleet):
    """The sample-mixing ops on this rank's half of each whole-batch input:
    the batch norm (``bn``: x, cotangent, scale, bias), the D2 masked mean
    and the per-image patch sum (``masked``: vec, valid, n), the StyleGAN2
    D's forward (``sg2``: state dict, x, cotangent, the D's arguments).
    Outputs and input gradients of this rank's rows; parameter gradients
    summed over the ranks.  Then a skitG step (``skit``: options, batch,
    draws; :func:`step_rank`) and a fleet garment's (``fleet``: the
    garments' argvs and batches, the epoch; :func:`fleet_rank`)."""
    from vts_torch.losses.gan_masked import masked_mean, masked_patch_sum
    from vts_torch.networks.blocks import BatchNorm
    from vts_torch.networks.stylegan2 import StyleGAN2Discriminator
    dp = _group()
    out = {}

    x, ct, scale, bias = (torch.from_numpy(a) for a in bn)
    norm = BatchNorm(x.shape[-1])
    with torch.no_grad():
        norm.scale.copy_(scale)
        norm.bias.copy_(bias)
    norm.group = dp
    xr = dp.rows(x).requires_grad_(True)
    y = norm(xr)
    gx, gs, gb = torch.autograd.grad(y, [xr, norm.scale, norm.bias], dp.rows(ct))
    dp.sum_(gs)
    dp.sum_(gb)
    out["bn"] = {"y": y.detach(), "dx": gx, "dscale": gs, "dbias": gb,
                 "mean": norm.mean.clone(), "var": norm.var.clone()}

    vec, valid, n = masked
    vec, valid = torch.from_numpy(vec), torch.from_numpy(valid)
    vr = dp.rows(vec).requires_grad_(True)
    count = dp.sum_(torch.sum(dp.rows(valid)).reshape(1))[0]
    share = masked_mean(vr, dp.rows(valid), count) + masked_patch_sum(vr, dp.rows(valid)) / n
    (g,) = torch.autograd.grad(share, vr)
    out["masked"] = {"value": dp.sum_(share.detach().clone().reshape(1))[0], "grad": g}

    sd, x, ct, kw = sg2
    net = StyleGAN2Discriminator(x.shape[-1], **kw)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    net.group = dp
    xr = dp.rows(torch.from_numpy(x)).requires_grad_(True)
    y = net(xr)
    grads = torch.autograd.grad(y, [xr] + list(net.parameters()), dp.rows(torch.from_numpy(ct)))
    for g in grads[1:]:
        dp.sum_(g)
    out["sg2"] = {"y": y.detach(), "dx": grads[0],
                  "dparams": dict(zip([k for k, _ in net.named_parameters()], grads[1:]))}
    out["skit"] = step_rank(*skit)
    out["fleet"] = fleet_rank(*fleet)
    return out


def setup_rank(opt):
    """The model of ``opt`` set up on this rank: its data group's (rank, size)."""
    from vts_torch.models import create_model
    model = create_model(opt)
    model.setup()
    return model.dp.rank, model.dp.size


def _state(model):
    out = {}
    for name, net in model.nets().items():
        out.update({f"{name}.{k}": v.detach().clone() for k, v in net.state_dict().items()})
        for m in ("mu", "nu"):
            out.update({f"{name}.{m}.{k}": v.clone()
                        for k, v in getattr(model.adam[name], m).items()})
    return out


def fleet_rank(argvs, batches, epoch):
    """This rank's garment of a fleet (one per rank): its slot trained one
    step on its batch; its losses and every tensor of its state, and the
    fleet's loss means gathered over the ranks."""
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    from vts_torch.parallel.fleet import FleetTrainer
    from vts_torch.platform import world
    rank = world().rank
    trainer = FleetTrainer(create_model(TrainOptions().parse(argvs[rank], quiet=True)), 1,
                           first=rank)
    trainer.init_states()
    trainer.step([batches[rank]], epoch)
    return {"losses": {k: torch.as_tensor(v) for k, v in trainer.losses[0].items()},
            "state": _state(trainer.model), "means": trainer.mean_losses(len(batches))}


def dp_step_rank(argv, states, batch, draws):
    """One data-parallel training step of the port on this rank's half of
    ``batch`` (the whole batch's draws given), from the networks'
    ``states`` (state dicts); its logged losses, Adam first moments and
    networks' state dicts."""
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    model = create_model(TrainOptions().parse(argv, quiet=True))
    model.setup()
    for name, sd in states.items():
        getattr(model, f"net{name}").load_state_dict({k: torch.from_numpy(np.asarray(v))
                                                      for k, v in sd.items()})
    model.set_input(batch)
    model.optimize_parameters(epoch=1, draws=draws)
    return {"losses": model.get_current_losses(),
            "mu": {n: dict(a.mu) for n, a in model.adam.items()},
            "state": {n: {k: v.clone() for k, v in net.state_dict().items()}
                      for n, net in model.nets().items()}}


def step_rank(opt, batch, draws):
    """The model of ``opt`` set up on this rank, one step on its half of
    ``batch`` with the whole batch's ``draws``: its losses and G's Adam
    first moment."""
    from vts_torch.models import create_model
    model = create_model(opt)
    model.setup()
    model.set_input(batch)
    model.optimize_parameters(1, draws=draws)
    return model.get_current_losses(), dict(model.adam["G"].mu), model._input["style_code"]
