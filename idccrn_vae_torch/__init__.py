"""PyTorch port of idccrn_vae_tpu for NVIDIA GPUs (H100).

The JAX package `idccrn_vae_tpu` is the reference each module is held
against; this package imports nothing of it, nor JAX. Layouts at the
public functions are the JAX package's: feature maps cpack
(B, F, T, 2C), spectra (B, F, T, 2), LSTM sequences (B, T, 2H).
"""
