from edgecape_tpu_torch.configs._base import test_config

config = test_config(split=5, shots=1)
