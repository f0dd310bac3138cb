"""Runnable examples of the port:

  python -m idccrn_vae_torch.examples.quickstart [workdir] [--device cpu]
      every stage on a synthetic mini-corpus at tiny geometry
"""
