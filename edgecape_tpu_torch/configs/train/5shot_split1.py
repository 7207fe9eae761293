from edgecape_tpu_torch.configs._base import train_config

config = train_config(split=1, shots=5)
