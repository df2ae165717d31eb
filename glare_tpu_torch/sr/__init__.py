"""The stage-1 codebook framework on PyTorch (counterpart of ``glare_tpu/sr/``,
the vendored BasicSR/RIDCP subset): registries with auto-import, the
weighted-codebook VQ autoencoder ``VQWeightDehazeNet`` (Swin RSTB blocks and the
DCN warp in its LQ stage), the spectral-norm UNet discriminator, registry
losses, the GAN trainer ``VQDehazeModel`` with a flat EMA and best-metric
tracking, datasets, metrics and the config-driven train / test pipelines.

    python -m glare_tpu_torch.sr.train -opt confs/stage1_HQ_pretrain.yml [--device cpu]

Not ported yet: ``archs/swinir_arch.py``, ``archs/arch_util.py``,
``data/haze_online_dataset.py`` with ``utils/{diffjpeg,img_process_util}.py``,
and ``utils/{lmdb_util,face_util,flow_util}.py``;
``utils/download_util.py`` is not ported by rule (nothing in the port fetches).
"""
