"""YAML config + command-line override merging.

Counterpart of wespeaker_tpu/utils/config.py: a YAML file merged with
'a.b=c' override strings (YAML-parsed values), then python kwargs, which
win; and the config written back as YAML. PyYAML is imported only where a
YAML file or value is parsed or written.
"""

from typing import Any, Dict, List, Optional


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def dump_yaml(config: Dict[str, Any], path: str):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)


def set_dotted(config: Dict[str, Any], key: str, value: Any):
    parts = key.split(".")
    node = config
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def parse_override(s: str):
    import yaml

    key, _, raw = s.partition("=")
    return key.strip(), yaml.safe_load(raw)


def parse_config_or_kwargs(config_file: str,
                           overrides: Optional[List[str]] = None,
                           **kwargs) -> Dict[str, Any]:
    """Load YAML; apply 'a.b=c' override strings, then python kwargs."""
    config = load_yaml(config_file)
    for ov in overrides or []:
        key, value = parse_override(ov)
        set_dotted(config, key, value)
    for key, value in kwargs.items():
        set_dotted(config, key, value)
    return config
