"""Hugging Face hub helpers for the port's checkpoint directories (the
port's copy of infgen_tpu/utils/hub.py).

    python -m infgen_torch.utils.hub upload --repo_id R [--ckpt_dir D]
    python -m infgen_torch.utils.hub download --repo_id R [--local_dir D]

uploads a checkpoint directory that `cli train --save-dir S` wrote
(S/ckpt, its step_*.pt files) to the hub repository R, or downloads R's
files into D, which `--ckpt-path D/ckpt` then reads. Optional: without the
`huggingface_hub` package every helper raises RuntimeError. The token
comes from `--token` or the HF_TOKEN environment variable.
"""

import os


def _require_hub():
    try:
        import huggingface_hub
        return huggingface_hub
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub is not installed; install it to use hub helpers"
        ) from e


def upload_checkpoint(ckpt_dir: str, repo_id: str, token: str = None):
    hub = _require_hub()
    api = hub.HfApi(token=token or os.environ.get("HF_TOKEN"))
    api.create_repo(repo_id, exist_ok=True)
    api.upload_folder(folder_path=ckpt_dir, repo_id=repo_id,
                      path_in_repo="ckpt")
    return f"https://huggingface.co/{repo_id}"


def download_checkpoint(repo_id: str, local_dir: str, token: str = None):
    hub = _require_hub()
    return hub.snapshot_download(repo_id, local_dir=local_dir,
                                 token=token or os.environ.get("HF_TOKEN"))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("infgen_torch.utils.hub")
    p.add_argument("mode", choices=["upload", "download"])
    p.add_argument("--repo_id", required=True)
    p.add_argument("--ckpt_dir", default="runs/default/ckpt")
    p.add_argument("--local_dir", default="runs/hub")
    p.add_argument("--token", default=None)
    args = p.parse_args(argv)
    if args.mode == "upload":
        print(upload_checkpoint(args.ckpt_dir, args.repo_id, args.token))
    else:
        print(download_checkpoint(args.repo_id, args.local_dir, args.token))


if __name__ == "__main__":
    main()
