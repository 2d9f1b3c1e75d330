"""nanowakeword (PyTorch port): unified CLI.

The counterpart of `nanowakeword_tpu/cli.py`: one command that routes on
flags, no subcommands.

Training pipeline
-----------------
  python -m nanowakeword_tpu_torch.cli -c config.yaml -G       # clips
  python -m nanowakeword_tpu_torch.cli -c config.yaml -t       # features
  python -m nanowakeword_tpu_torch.cli -c config.yaml -T       # train
  python -m nanowakeword_tpu_torch.cli -c config.yaml          # stages from
                                                               # the config
  python -m nanowakeword_tpu_torch.cli -c config.yaml -T --resume DIR
  python -m nanowakeword_tpu_torch.cli -c config.yaml -d       # lite gate
                                                               # from the
                                                               # exported .nww

`-f` re-verifies the data directories of a config with `convert_audio:
true`, ignoring the cached receipts.

Server
------
  python -m nanowakeword_tpu_torch.cli --model my_model.nww
  python -m nanowakeword_tpu_torch.cli --model my_model.nww --pipeline full
  python -m nanowakeword_tpu_torch.cli --model my_model.onnx

Model info
----------
  python -m nanowakeword_tpu_torch.cli --info my_model.nww
  python -m nanowakeword_tpu_torch.cli --info my_model.onnx
"""

from __future__ import annotations

import argparse
import os
import sys


def _lazy_load_yaml_config(config_path: str) -> dict:
    try:
        import yaml
    except ImportError:
        print("Error: PyYAML is required to load config files.")
        sys.exit(1)
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"Config file not found: {config_path}")
    try:
        with open(config_path, "r", encoding="utf-8") as f:
            return yaml.load(f, yaml.Loader)
    except yaml.YAMLError as e:
        print(f"Error parsing YAML config file: {e}")
        sys.exit(1)


def _get_pipeline_stages_from_config(config: dict) -> dict:
    return {
        "generate_clips": config.get("generate_clips", False),
        "transform_clips": config.get("transform_clips", False),
        "train_model": config.get("train_model", False),
        "distill": config.get("distill", False),
    }


def _merge_config_with_cli_args(config_stages: dict, args) -> dict:
    merged = dict(config_stages)
    if args.generate_clips:
        merged["generate_clips"] = True
    if args.transform_clips:
        merged["transform_clips"] = True
    if args.train:
        merged["train_model"] = True
    if args.distill:
        merged["distill"] = True
    return merged


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="nanowakeword-torch",
        description="nanowakeword, PyTorch port - wake word detection "
                    "engine on one torch device.",
        formatter_class=argparse.RawTextHelpFormatter,
        epilog=(
            "Examples:\n"
            "  nanowakeword-torch -c config.yaml -t -T\n"
            "  nanowakeword-torch -c config.yaml\n"
            "  nanowakeword-torch --model my_model.nww --pipeline full\n"
            "  nanowakeword-torch --info my_model.nww\n"
            "  nanowakeword-torch --bench\n"))

    train_group = parser.add_argument_group("Training pipeline (-c required)")
    train_group.add_argument("-c", "--config", metavar="PATH", default=None,
                             help="Path to the training configuration YAML.")
    train_group.add_argument("-G", "--generate_clips", action="store_true",
                             help="Generate synthetic audio clips.")
    train_group.add_argument("-t", "--transform_clips", action="store_true",
                             help="Augment clips and extract features.")
    train_group.add_argument("-T", "--train", action="store_true",
                             help="Train the wake word model.")
    train_group.add_argument("-d", "--distill", action="store_true",
                             help="Distill a lite gate model (with -T or "
                                  "standalone).")
    train_group.add_argument("-f", "--force-verify", action="store_true",
                             help="Re-verify all data directories.")
    train_group.add_argument("--overwrite", action="store_true",
                             help="Overwrite existing feature files.")
    train_group.add_argument("--resume", metavar="PATH", default=None,
                             help="Resume training from a project directory.")

    server_group = parser.add_argument_group("Server (--model required)")
    server_group.add_argument("--model", metavar="PATH", default=None,
                              help="Wake word .nww or .onnx model; starts "
                                   "the RemoteVerifier server.")
    server_group.add_argument("--pipeline", default="verifier_only",
                              choices=["verifier_only", "embedding", "full"],
                              metavar="MODE",
                              help="verifier_only | embedding | full")
    server_group.add_argument("--host", default="0.0.0.0", metavar="HOST")
    server_group.add_argument("--port", default=8765, type=int,
                              metavar="PORT")
    server_group.add_argument("--log", default="INFO",
                              choices=["DEBUG", "INFO", "WARNING", "ERROR"],
                              metavar="LEVEL")
    server_group.add_argument("--api-key", dest="api_keys", action="append",
                              default=[], metavar="KEY")
    server_group.add_argument("--enable-tokens", action="store_true")
    server_group.add_argument("--token-ttl", type=int, default=3600,
                              metavar="SECONDS")
    server_group.add_argument("--token-secret", default=None,
                              metavar="SECRET")
    server_group.add_argument("--rate-limit", type=int, default=0,
                              metavar="COUNT")
    server_group.add_argument("--rate-window", type=int, default=60,
                              metavar="SECONDS")
    server_group.add_argument("--ip-allowlist", action="append", default=[],
                              metavar="IP_OR_CIDR")
    server_group.add_argument("--ssl-certfile", default=None, metavar="PATH")
    server_group.add_argument("--ssl-keyfile", default=None, metavar="PATH")
    server_group.add_argument("--ssl-ca-certs", default=None, metavar="PATH")
    server_group.add_argument("--max-connections", type=int, default=0,
                              metavar="COUNT")
    server_group.add_argument("--ban-duration", type=int, default=300,
                              metavar="SECONDS")
    server_group.add_argument("--no-batching", action="store_true",
                              help="Disable cross-client dynamic "
                                   "micro-batching.")
    server_group.add_argument("--max-batch", type=int, default=256,
                              metavar="N")
    server_group.add_argument("--batch-wait-ms", type=float, default=4.0,
                              metavar="MS")
    server_group.add_argument("--data-parallel", type=int, default=0,
                              metavar="N",
                              help="Shard batched scoring over N devices "
                                   "(-1 = all, 0 = off).")

    parser.add_argument("--device", default="cuda", metavar="DEVICE",
                        help="torch device for training and serving "
                             "(default: cuda).")
    parser.add_argument("--info", metavar="MODEL", default=None,
                        help="Show metadata for a .nww or .onnx model file "
                             "and exit.")
    parser.add_argument("--bench", action="store_true",
                        help="Run the throughput benchmark's headline on "
                             "--device and exit.")
    return parser


def _run_training(args, config_stages=None):
    if config_stages:
        stages = _merge_config_with_cli_args(config_stages, args)
    else:
        stages = {
            "generate_clips": args.generate_clips,
            "transform_clips": args.transform_clips,
            "train_model": args.train,
            "distill": args.distill,
        }
    argv = ["-c", args.config, "--device", args.device]
    if stages["generate_clips"]:
        argv.append("-G")
    if stages["transform_clips"]:
        argv.append("-t")
    if stages["train_model"]:
        argv.append("-T")
    if stages["distill"]:
        argv.append("-d")
    if args.force_verify:
        argv.append("-f")
    if args.overwrite:
        argv.append("--overwrite")
    if args.resume:
        argv += ["--resume", args.resume]

    from nanowakeword_tpu_torch.trainer import train
    train(cli_args=argv)


def _run_server(args):
    from nanowakeword_tpu_torch.interpreter.remote_verifier import serve
    from nanowakeword_tpu_torch.interpreter.server_security import \
        build_security

    security = build_security(
        api_keys=args.api_keys, enable_tokens=args.enable_tokens,
        token_ttl=args.token_ttl, token_secret=args.token_secret,
        rate_limit=args.rate_limit, rate_window=args.rate_window,
        ip_allowlist=args.ip_allowlist, ssl_certfile=args.ssl_certfile,
        ssl_keyfile=args.ssl_keyfile, ssl_ca_certs=args.ssl_ca_certs,
        max_connections=args.max_connections,
        ban_duration=args.ban_duration)
    serve(model_path=args.model, pipeline=args.pipeline, host=args.host,
          port=args.port, log_level=args.log, security=security,
          batching=not args.no_batching, max_batch=args.max_batch,
          batch_wait_ms=args.batch_wait_ms,
          data_parallel=args.data_parallel, device=args.device)


def _run_info_onnx(model_path: str):
    """Model info for an exported .onnx file, read with the bundled protobuf
    parser (no onnx or onnxruntime)."""
    import numpy as np

    from nanowakeword_tpu_torch.export import onnx_proto as P

    parsed = P.load_model(model_path)
    g = parsed.graph
    # weight-only int8 graphs keep kernels as int8 initializers; their
    # per-channel scale vectors (DequantizeLinear's 2nd input) are no params
    scale_names = {nd.inputs[1] for nd in g.nodes
                   if nd.op_type == "DequantizeLinear"}
    n_params = int(sum(np.prod(a.shape)
                       for name, a in g.initializers.items()
                       if a.dtype in (np.float32, np.int8)
                       and name not in scale_names))
    quantized = any(a.dtype == np.int8 for a in g.initializers.values())
    size_kb = os.path.getsize(model_path) / 1024
    name = os.path.splitext(os.path.basename(model_path))[0]
    ops = sorted({nd.op_type for nd in g.nodes})

    print(f"\n  Model         {name}")
    print(f"  Path          {model_path}")
    is_lite = name.endswith("_lite")
    print(f"  Type          "
          f"{'lite / gate model' if is_lite else 'full / verifier model'}")
    print(f"  File size     {size_kb:.1f} KB")
    print(f"  Parameters    {n_params:,}")
    print(f"  Format        ONNX (opset {parsed.opsets.get('', '?')}, "
          f"ir {parsed.ir_version}, producer {parsed.producer})")
    if quantized:
        print("  Weights       weight-only int8 (per-channel "
              "DequantizeLinear)")
    print(f"  Graph         {len(g.nodes)} nodes: {', '.join(ops)}")
    print("\n  Inputs")
    for vi in g.inputs:
        print(f"    {vi.name:<20} shape={vi.shape}")
    print("\n  Outputs")
    for vi in g.outputs:
        print(f"    {vi.name:<20} shape={vi.shape}  (sigmoid probability)")
    print()


def _run_info(model_path: str):
    if not os.path.exists(model_path):
        print(f"Error: model not found at '{model_path}'")
        sys.exit(1)
    if model_path.endswith(".onnx"):
        _run_info_onnx(model_path)
        return

    from nanowakeword_tpu_torch.export.artifact import read_nww_header

    header = read_nww_header(model_path)
    name = header.get("model_name", os.path.basename(model_path))
    size_kb = os.path.getsize(model_path) / 1024
    is_lite = name.endswith("_lite")
    stateful = header.get("stateful", False)
    shape = header.get("input_shape", ["?", "?"])
    n_params = header.get("n_params")

    print(f"\n  Model         {name}")
    print(f"  Path          {model_path}")
    print(f"  Type          "
          f"{'lite / gate model' if is_lite else 'full / verifier model'}")
    print(f"  File size     {size_kb:.1f} KB")
    print(f"  Parameters    {n_params:,}" if isinstance(n_params, int)
          else "  Parameters    unknown")
    print(f"  Architecture  {header.get('model_type', '?')} "
          f"({'stateful (carry)' if stateful else 'stateless'})")
    wd = header.get("weights_dtype", "float32")
    if wd != "float32":
        print(f"  Weights       {wd} (restored to float32 at load)")
    print(f"  Frontend      "
          f"{'bundled encoder' if header.get('has_encoder') else 'external'}")
    print("\n  Inputs")
    print(f"    input                 shape=['batch', {shape[0]}, {shape[1]}]")
    print("\n  Outputs")
    print("    output                shape=['batch', 1, 1]  "
          "(sigmoid probability)")
    print()


def main(argv=None):
    parser = _build_parser()
    args = parser.parse_args(argv)

    if args.info:
        _run_info(args.info)
        return
    if args.bench:
        from nanowakeword_tpu_torch import bench
        bench.main(["--device", args.device])
        return
    if args.model:
        _run_server(args)
        return
    if args.config:
        training_flags = (args.generate_clips or args.transform_clips
                          or args.train or args.distill)
        config_stages = None
        if not training_flags:
            try:
                config = _lazy_load_yaml_config(args.config)
                config_stages = _get_pipeline_stages_from_config(config)
                if not any(config_stages.values()):
                    parser.error(
                        "No pipeline stages specified!\n"
                        "Provide at least one of these:\n"
                        "  CLI flags: -t, -T, -d\n"
                        "  OR in config file: transform_clips, train_model, "
                        "distill")
            except FileNotFoundError as e:
                parser.error(f"Config file not found: {args.config}\n{e}")
        _run_training(args, config_stages)
        return

    parser.print_help()
    sys.exit(1)


if __name__ == "__main__":
    main()
