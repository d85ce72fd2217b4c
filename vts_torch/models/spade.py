"""SPADE (GauGAN) — the paper's third baseline (``vts_tpu/models/spade.py``,
reference models/spade_model.py): the SPADE generator from the sketch as
its segmap to the 5-channel (image, touch) output, with spectral-norm convs
and the param-free sync batch norm (``--normG spectralspadesyncbatch3x3``);
two ``multiscale`` spectral-instance Ds with intermediate features — D on
(S, I), D2 on (S, T), 2 scales each — trained with the hinge GAN,
GAN-feat·``lambda_feat`` and VGG19·``lambda_vgg`` on 32² patches (the
patchskit dataset, batch 16) under TTUR, and tested on the full canvas.

One training step is the reference's ``_train_step``, in
:class:`~vts_torch.models.pix2pixhd.Pix2PixHDModel`'s order, with three
differences:

  * the rates: G at lr/2, D and D2 both at 2·lr (``--lr_G2`` is not read),
    all at lr under ``--no_TTUR``;
  * G_GAN_Feat always matches the fake features against the real-side ones
    of the D updates (the Ds before their Adam step); ``--correct_gan_feat``
    is not read;
  * each spectral conv's ``u`` advances once per pass that keeps its
    stats: G's once in its forward; a D's in its fake pass and again, from
    there, in its real pass, so its loss sums terms under two σ; G's pass
    through the updated Ds computes σ from their ``u`` and keeps nothing.

The hinge loss for a "real" target is relu(1 − p), as the reference's
``gan_loss`` has it for G too (upstream GauGAN takes −mean(p) there).  The
pool's draws come from :meth:`draw`.  ``--niter_fix_global`` freezes
nothing: the SPADE G has no global scope (the reference's step ignores
the mask it builds).

``--use_vae true`` is refused: the reference cannot run it (its ``setup``
initializes G without a z sample, and its step applies the train-mode
encoder without a mutable collection); the encoder and the KLD loss are in
:mod:`vts_torch.networks.spade_nets`.  ``test()``, the metrics, the
checkpoints (``u`` and the running statistics in the ``stats``) and the
gallery without ``pred_fake_T_full`` are pix2pix's.
"""

from __future__ import annotations

from .pix2pixhd import Pix2PixHDModel


class SPADEModel(Pix2PixHDModel):
    always_matches_real = True

    def __init__(self, opt):
        if opt.use_vae:
            raise ValueError("--use_vae true: the reference's SPADE cannot run it (its setup "
                             "initializes G with the sketch alone and fails on 'VAE mode needs "
                             "a z sample'; its step then applies the train-mode ConvEncoder "
                             "without a mutable batch_stats collection)")
        super().__init__(opt)

    def _rates(self, lr: float, lr_d2: float):
        """TTUR: G at lr/2, D and D2 at 2·lr; every network at lr under
        ``--no_TTUR``."""
        if self.opt.no_TTUR:
            return lr, lr, lr
        return lr / 2.0, lr * 2.0, lr * 2.0
