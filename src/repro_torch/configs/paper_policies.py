"""The paper's own policy models (Table 6), keyed by benchmark name."""
from repro_torch.envs.suite import SPECS

POLICY_DIMS = {name: spec.policy_dims for name, spec in SPECS.items()}
