"""Warm-starting pose-net towers from a trained donor (counterpart of
pose6d_tpu/train/warmstart.py): tree surgery on the port's state_dicts.

The reference starts every ResNet tower from ImageNet weights; with none
on hand, trained towers of a donor run are grafted into a fresh init.
Adam's moments are zero at step 0, so grafting before the first step is
exact.
"""

from typing import Dict, List, Tuple

# tower scopes a PoseNet variant may own (models/posenet.py)
_TOWER_SCOPES = ("backbone", "rgb_backbone", "depth_backbone")
# a single-tower donor ("backbone") maps onto the dual-tower variants' RGB tower
_ALIASES = {"rgb_backbone": "backbone"}
# a state_dict entry's flax collection: BatchNorm buffers are flax's
# "batch_stats", everything else its "params"
_STATS_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def _collection(key: str) -> str:
    return "batch_stats" if key.endswith(_STATS_SUFFIXES) else "params"


def _scope(sd: Dict, scope: str) -> Dict:
    """{key after 'scope.': value} of the entries under `scope`."""
    prefix = scope + "."
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def graft_towers(target: Dict, donor: Dict) -> Tuple[Dict, List[str]]:
    """Copy every tower scope present in both state_dicts from donor into
    a copy of target. A target scope with no same-named donor scope falls
    back to its alias (donor 'backbone' -> target 'rgb_backbone'). Returns
    (new_target, grafted), grafted listing
    "<target scope><-<donor scope>[params+batch_stats]". A tower's
    parameters and its BN statistics travel together: a donor scope that
    lacks one of the collections the target scope has raises, as does a
    donor tower of other keys, or no match at all."""
    new = dict(target)
    grafted: List[str] = []
    for scope in _TOWER_SCOPES:
        tgt = _scope(target, scope)
        if not any(_collection(k) == "params" for k in tgt):
            continue
        src = scope if _scope(donor, scope) else _ALIASES.get(scope)
        if src is None:
            continue
        don = _scope(donor, src)
        if not any(_collection(k) == "params" for k in don):
            continue
        want = [c for c in ("params", "batch_stats") if any(_collection(k) == c for k in tgt)]
        have = [c for c in want if any(_collection(k) == c for k in don)]
        if have != want:
            raise ValueError(
                f"graft_towers: donor scope '{src}' covers collections {have} but target "
                f"scope '{scope}' needs {want}; grafting params without matching batch_stats "
                "(or vice versa) would skew any eval of the grafted model")
        keys = [k for k in tgt if _collection(k) in want]
        missing = [k for k in keys if k not in don]
        if missing:
            raise ValueError(f"graft_towers: donor scope '{src}' lacks {len(missing)} entries "
                             f"of target scope '{scope}', e.g. {missing[:3]}")
        for k in keys:
            new[f"{scope}.{k}"] = don[k]
        grafted.append(f"{scope}<-{src}[{'+'.join(want)}]")
    if not grafted:
        towers = lambda sd: sorted({k.split(".")[0] for k in sd})  # noqa: E731
        raise ValueError("graft_towers: no tower scope of the target matches the donor "
                         f"(target scopes {towers(target)}, donor scopes {towers(donor)})")
    return new, grafted
