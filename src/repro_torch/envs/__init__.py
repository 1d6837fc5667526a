from repro_torch.envs.base import (EnvSpec, EnvState, MegaConsts,  # noqa: F401
                                   VectorEnv, derive_seeds)
from repro_torch.envs.multi_agent import (MultiAgentVectorEnv,  # noqa: F401
                                          make_multi_agent_env)
from repro_torch.envs.suite import (SPECS, all_env_names,  # noqa: F401
                                    build_env, make_env)
