"""The frozen reference against the port on the CPU at a tiny size, in
float32: the forward, the device augmentation, the training step and the
multi-scale evaluation agree, so that on the card only precision and the
kernels set them apart."""

import numpy as np
import pytest
import torch

from port_bench.loops.eval_msc import reference_probs
from port_bench.frames import block_labels, city_trainids, city_raw_labels, smooth_frames
from port_bench.reference import augment as ref_aug
from port_bench.reference import train as ref_train
from port_bench.reference.model import CABiNet
from port_bench.weights import make_state_dict


def port_model(sd, n_classes, attention="plain"):
    from cabinet_tpu_torch.models.cabinet import CABiNet as Port

    m = Port(n_classes, attention=attention)
    m.load_state_dict(sd)
    return m


def test_forward_matches_the_port():
    sd = make_state_dict(8, 11, "cpu", calib_hw=64)
    ref = CABiNet(8)
    ref.load_state_dict(sd)
    x = torch.randn(2, 3, 96, 128)
    with torch.no_grad():
        a = ref.eval()(x)
        b = port_model(sd, 8).eval()(x)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-5)


def test_augmentation_matches_device_augment(tmp_path):
    from cabinet_tpu_torch.cli.train import DeviceAugment
    from cabinet_tpu_torch.core.config import Config

    B, S, h, w, crop = 3, 128, 64, 128, (64, 64)
    img = smooth_frames(5, B, h, w, "cpu")
    lbl = city_trainids(city_raw_labels(block_labels(5, B, h, w, 19, "cpu")))
    canvas = np.zeros((B, S, S, 3), np.uint8)
    labels = np.full((B, S, S), 255, np.uint8)
    canvas[:, :h, :w], labels[:, :h, :w] = img, lbl
    hw = np.tile(np.array([[h, w]], np.int32), (B, 1))

    class DS:  # the street train set's device-mode surface
        geometric, RECIPE = "device", "street"
        aug = {"fliplr": 0.5, "flipud": 0.0, "degrees": 0.0, "translate": 0.0,
               "scale_choices": ref_aug.SCALE_CHOICES, "mixup": 0.0}
        MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)

    cfg = Config({"runtime": {"seed": 40, "device_geometric": True},
                  "dataset": {"ignore_idx": 255}})
    got = DeviceAugment(cfg, DS(), torch.device("cpu"), crop)((canvas, labels, hw), 4000, 0)
    want = ref_aug.augment(torch.from_numpy(canvas), torch.from_numpy(labels), hw, 41,
                           4000, 0, crop, 255, DS.MEAN, DS.STD)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    assert torch.equal(got[1], want[1])


def test_training_steps_match_the_port():
    from cabinet_tpu_torch.train.optimizer import GroupedSGD
    from cabinet_tpu_torch.train.trainer import create_train_state, make_train_step

    t = {"lr0": 5e-3, "momentum": 0.9, "weight_decay": 5e-4, "power": 0.9,
         "warmup_steps": 4000, "warmup_start_lr": 1e-5, "lr_multiplier": 10.0,
         "max_iterations": 92000, "max_grad_norm": 1.0, "ema_decay": 0.9999,
         "ema_tau": 2000, "ohem_thresh": 0.7, "aux_weight": 1.0}
    sd = make_state_dict(19, 3, "cpu", calib_hw=64)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 64, 3, generator=g)
    y = torch.randint(0, 19, (2, 64, 64), generator=g)
    y[:, :4] = 255
    cw = torch.rand(19, generator=g) + 0.5
    n_min = 2 * 64 * 64 // 16

    ref = CABiNet(19)
    ref.load_state_dict(sd)
    trainer = ref_train.Trainer(ref, t, 4000)
    port = port_model(sd, 19, "einsum")
    opt = GroupedSGD(port, lr0=t["lr0"], max_iter=t["max_iterations"], momentum=0.9,
                     wd=5e-4, power=0.9, warmup_steps=4000, warmup_start_lr=1e-5,
                     max_grad_norm=1.0)
    state = create_train_state(port, opt, 0.9999, 2000)
    state.step = 4000
    step = make_train_step(n_min, 0.7, 255, cw.numpy(), compute_dtype=torch.float32)
    for _ in range(2):
        state, loss = step(state, x, y)
        want = trainer.step(x, y, n_min, cw, 255)
        assert float(loss) == pytest.approx(want, rel=1e-5)
    for n, p in port.named_parameters():
        torch.testing.assert_close(p.detach(), dict(ref.named_parameters())[n].detach(),
                                   rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(state.ema.shadow[n], trainer.ema[n], rtol=1e-4, atol=1e-6)


def test_multi_scale_probabilities_match_mscEval():
    from cabinet_tpu_torch.eval.evaluator import MscEval

    sd = make_state_dict(19, 4, "cpu", calib_hw=64)
    port = port_model(sd, 19).eval()

    def apply_fn(_, images):
        with torch.no_grad():
            return tuple(t.permute(0, 2, 3, 1) for t in port(images.permute(0, 3, 1, 2)))

    x = np.random.default_rng(0).standard_normal((2, 64, 128, 3)).astype(np.float32)
    msc = MscEval(apply_fn, 19, scales=(0.75, 1.25), flip=True, cropsize=64,
                  tile_batch=4, device="cpu")
    got = torch.from_numpy(msc.prob_batch(None, x))
    ref = CABiNet(19)
    ref.load_state_dict(sd)
    want = reference_probs(ref.eval(), torch.from_numpy(x), 19, 64, (0.75, 1.25), True)
    # the port folds tiles and flips into other batches than the reference,
    # and float32 convolutions sum in another order at another batch size
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
