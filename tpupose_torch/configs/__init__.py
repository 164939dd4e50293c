from tpupose_torch.configs.default import Config, default_config
from tpupose_torch.configs.parser import load_config, parse_args, update_config

__all__ = ["Config", "default_config", "parse_args", "update_config", "load_config"]
