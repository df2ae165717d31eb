"""The stage-1 codebook framework on PyTorch (counterpart of ``glare_tpu/sr/``,
the vendored BasicSR/RIDCP subset): registries with auto-import, the
weighted-codebook VQ autoencoder ``VQWeightDehazeNet`` (Swin RSTB blocks and the
DCN warp in its LQ stage), the spectral-norm UNet discriminator, registry
losses, the GAN trainer ``VQDehazeModel`` with a flat EMA and best-metric
tracking, datasets, metrics and the config-driven train / test pipelines.

    python -m glare_tpu_torch.sr.train -opt confs/stage1_HQ_pretrain.yml [--device cpu]

Also the rest of the vendored tree: the full ``SwinIR`` (``archs/swinir_arch.py``
on ``archs/arch_util.py``), RIDCP's on-the-fly haze synthesis
(``data/haze_online_dataset.py``), the device degradations ``utils/diffjpeg.py``
and ``utils/img_process_util.py`` (``filter2D``, ``USMSharp``), and the host
utilities ``utils/{lmdb_util,flow_util,face_util}.py``. ``utils/download_util.py``
is not ported by rule (nothing in the port fetches).
"""
