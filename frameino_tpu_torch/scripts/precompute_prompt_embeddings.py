"""Precompute the UMT5 / T5 prompt embeddings of a training dataset
(counterpart of ``scripts/precompute_prompt_embeddings.py``).

    python -m frameino_tpu_torch.scripts.precompute_prompt_embeddings \
        --csv_folder <dataset CSV folder> \
        --text_encoder_path <checkpoint dir: config.json, safetensors and
                             the tokenizer's files> \
        --output_dir <cache dir> [--kind umt5|t5] [--max_text_len N] \
        [--batch_size 8] [--prompt_column ...] [--include_empty] \
        [--device cpu]

The unique prompts of the CSV folder are embedded once into the cache that
``data/prompt_cache.PromptEmbeddingCache`` reads, which the train entries
take through the ``prompt_embeds_cache`` config key. ``--kind`` names the
family's encoder: ``umt5`` (Wan2.2, 512 tokens) or ``t5`` (CogVideoX's
T5-XXL, 226 tokens); ``--max_text_len`` overrides its length. The encoder
runs through ``serve.build_text_encoder_fn`` (bf16 on the card, fp32 on
the CPU); the tokenizer is ``transformers.AutoTokenizer`` of the
checkpoint directory unless ``main`` is given one.
"""

from __future__ import annotations

import argparse
import json

TEXT_LEN = {"umt5": 512, "t5": 226}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csv_folder", required=True)
    p.add_argument("--text_encoder_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--kind", choices=sorted(TEXT_LEN), default="umt5")
    p.add_argument("--max_text_len", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--prompt_column", default="Structured_Text_Prompt")
    p.add_argument("--include_empty", action="store_true",
                   help="also cache the empty prompt (text dropout)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def collect_prompts(csv_folder: str, column: str):
    """The sorted unique non-empty prompts of ``column`` (a JSON list of
    prompts, a JSON string, or plain text) over the folder's CSVs."""
    from frameino_tpu_torch.data.csv_io import read_csv_folder, row_dict
    header, rows = read_csv_folder(csv_folder)
    prompts = set()
    for row in rows:
        raw = row_dict(header, row).get(column)
        if raw is None:
            continue
        try:
            vals = json.loads(raw)
        except json.JSONDecodeError:
            vals = [raw]
        for v in vals if isinstance(vals, list) else [vals]:
            if isinstance(v, str) and v:
                prompts.add(v)
    return sorted(prompts)


def main(argv=None, tokenizer=None) -> int:
    """Embed and cache; returns the number of prompts the cache holds."""
    args = parse_args(argv)
    from frameino_tpu_torch.data.prompt_cache import PromptEmbeddingCache
    from frameino_tpu_torch.serve import build_text_encoder_fn
    max_len = args.max_text_len or TEXT_LEN[args.kind]
    encode = build_text_encoder_fn(args.text_encoder_path,
                                   tokenizer=tokenizer, device=args.device,
                                   max_length=max_len)
    model_cfg = encode.model.cfg
    held = "umt5" if model_cfg.per_layer_relative_bias else "t5"
    if held != args.kind:
        raise ValueError(f"{args.text_encoder_path} holds a {held} encoder, "
                         f"not --kind {args.kind}")

    prompts = collect_prompts(args.csv_folder, args.prompt_column)
    if args.include_empty:
        prompts = [""] + prompts
    print(f"embedding {len(prompts)} unique prompts")
    cache = PromptEmbeddingCache(args.output_dir, max_len, model_cfg.d_model,
                                 create=True)
    for i in range(0, len(prompts), args.batch_size):
        chunk = prompts[i:i + args.batch_size]
        emb = encode(chunk).cpu().numpy()
        for p, e in zip(chunk, emb):
            cache.put(p, e)
        print(f"  {min(i + args.batch_size, len(prompts))}/{len(prompts)}")
    print(f"wrote {len(cache)} embeddings -> {args.output_dir}")
    return len(cache)


if __name__ == "__main__":
    main()
