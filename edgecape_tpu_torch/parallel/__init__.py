"""Multi-process training and eval on torch.distributed; counterpart of
edgecape_tpu/parallel/. One process drives one device (a card, or the
CPU under gloo)."""
