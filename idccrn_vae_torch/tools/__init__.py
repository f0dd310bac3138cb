"""Tools of the port that chain its entry points:

  python -m idccrn_vae_torch.tools.e2e_train ...   the whole recipe,
      trained and evaluated end to end (tools/e2e_train_tpu.py's
      counterpart)
"""
