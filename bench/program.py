"""What the entries share: the program's engine for a configuration and
the traffic's types in the program's encoding."""
import torch

from repro_torch.vector import MultiQueryEngine, VectorEngine

#: the code of a type no query names: it matches no predicate
NOISE = -1.0


def engine(cfg: dict, device):
    """The configuration's queries compiled into one engine: packed when
    there are several."""
    qs = [cfg["query"].format(seq=q, window=cfg["window"])
          for q in cfg["queries"]]
    return (MultiQueryEngine(qs, device=device) if len(qs) > 1
            else VectorEngine(qs[0], device=device))


def type_codes(eng, type_names, device) -> torch.Tensor:
    """(len(type_names),) f32: each type's attribute code in ``eng``'s
    encoder."""
    vocab = eng.encoder.vocab["type"]
    return torch.tensor([vocab.get(t, NOISE) for t in type_names],
                        dtype=torch.float32, device=device)
