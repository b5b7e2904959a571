"""Device discovery CLI for the CUDA port.

  python -m flash_attention_tpu_torch.utils.devices          # human-readable
  python -m flash_attention_tpu_torch.utils.devices --count  # just the number
"""

from __future__ import annotations

import argparse
import json

import torch


def device_info() -> list[dict]:
    """One entry per visible CUDA device: id, name, compute capability and
    memory.  Empty when there is no card."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append(
            {
                "id": i,
                "platform": "gpu",
                "kind": props.name,
                "capability": [props.major, props.minor],
                "memory_bytes": props.total_memory,
                "sms": props.multi_processor_count,
            }
        )
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--count", action="store_true")
    p.add_argument("--json", action="store_true")
    args = p.parse_args()
    info = device_info()
    if args.count:
        print(len(info))
    elif args.json:
        print(json.dumps(info))
    else:
        for d in info:
            cap = ".".join(map(str, d["capability"]))
            print(f"device {d['id']}: {d['kind']} (sm {cap}, {d['sms']} SMs)")


if __name__ == "__main__":
    main()
