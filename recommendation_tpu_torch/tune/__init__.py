from recommendation_tpu_torch.tune.tuner import (  # noqa: F401
    GridTuner,
    UnivariateTuner,
    generate_independent_grid,
    print_summary,
)
