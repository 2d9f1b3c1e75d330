"""User-configurable export hook.

A copy of `nanowakeword_tpu/export/custom_export.py`: after the built-in
exports the pipeline invokes a user Python function (`custom_export.script`
+ optional `function`, default `export_model`) or a shell command with
`{model_path}`, `{model_name}`, `{output_dir}` placeholders. Same config
keys; `model_path` points at the `.nww` artifact.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
from typing import Any, Tuple

from nanowakeword_tpu_torch.export.artifact import EXTENSION
from nanowakeword_tpu_torch.utils.logger import print_info, print_warning


def export_custom_model(model: Any, input_shape: Tuple[int, ...], config,
                        model_name: str, output_dir: str) -> bool:
    export_cfg = (config.get("custom_export") or config.get("export_model")
                  or {})
    if not export_cfg:
        return False

    script_path = export_cfg.get("script")
    func_name = export_cfg.get("function", "export_model")
    if script_path:
        try:
            spec = importlib.util.spec_from_file_location(
                "user_export_module", script_path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            func = getattr(module, func_name, None)
            if not func:
                print_warning(f"User export script '{script_path}' has no "
                              f"function '{func_name}'. Skipping.")
                return False
            # decide the calling convention from the signature BEFORE
            # invoking: a retry-on-TypeError would re-run a user function
            # (twice the side effects) whose TypeError came from inside it
            import inspect
            kwargs = dict(model=model, input_shape=input_shape,
                          config=config, model_name=model_name,
                          output_dir=output_dir)
            try:
                params = inspect.signature(func).parameters
                accepts_kw = (all(k in params for k in kwargs)
                              or any(p.kind is inspect.Parameter.VAR_KEYWORD
                                     for p in params.values()))
            except (TypeError, ValueError):   # builtins/C callables
                accepts_kw = False
            if accepts_kw:
                func(**kwargs)
            else:
                func(model, input_shape, config, model_name, output_dir)
            print_info(f"User export script '{script_path}' executed "
                       "successfully.")
            return True
        except Exception as e:  # noqa: BLE001
            print_warning(f"User export script failed: {e}")

    cmd = export_cfg.get("command")
    if cmd:
        try:
            model_path = os.path.join(output_dir, model_name + EXTENSION)
            formatted = cmd.format(model_path=model_path,
                                   model_name=model_name,
                                   output_dir=output_dir)
            subprocess.run(formatted, shell=True, check=True)
            print_info("User export command executed successfully.")
            return True
        except Exception as e:  # noqa: BLE001
            print_warning(f"User export command failed: {e}")
    return False


def auto_gen_name(model_type: str, base_dir: str = ".",
                  prefix: str = "nww") -> str:
    """Versioned model-name generation, `nww_<type>_model_vN`
    (`_export/auto_gen_name.py:21-55`)."""
    import re
    model_type = model_type.lower().strip()
    pattern = re.compile(rf"^{prefix}_{model_type}_model_v(\d+)$")
    existing = []
    try:
        for name in os.listdir(base_dir):
            m = pattern.match(name)
            if m:
                existing.append(int(m.group(1)))
    except FileNotFoundError:
        pass
    return f"{prefix}_{model_type}_model_v{max(existing, default=0) + 1}"
