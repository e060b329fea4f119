"""Interactive nearest-neighbour console (port of
goctr_tpu/embedding/console.py; the reference's search console): load a
text model file, type a word, get the top-k cosine neighbours.

    python -m goctr_tpu_torch.embedding.console model.txt [k] [device]

device defaults to cuda.
"""
from __future__ import annotations

import sys

from goctr_tpu_torch.embedding.search import Searcher
from goctr_tpu_torch.embedding.store import load_embedding_map


def repl(model_path: str, k: int = 10, device: str = "cuda") -> None:
    emb = load_embedding_map(model_path)
    searcher = Searcher(emb, device=device)
    print(f"loaded {len(emb)} x {emb.dim} embeddings; "
          f"type a word (empty line to quit)")
    while True:
        try:
            word = input(">> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not word:
            break
        results = searcher.search(word, k=k)
        if not results:
            print(f"  {word!r} not in vocabulary")
            continue
        width = max(len(w) for w, _ in results)
        print(f"  {'RANK':<5} {'WORD':<{width}}  SIMILARITY")
        for rank, (w, sim) in enumerate(results, 1):
            print(f"  {rank:<5} {w:<{width}}  {sim:.6f}")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    repl(argv[0], int(argv[1]) if len(argv) > 1 else 10,
         argv[2] if len(argv) > 2 else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
