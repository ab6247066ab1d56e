from deep_recommenders_torch.serving.export import (
    ServingModule,
    export_model,
    load_serving_module,
)
from deep_recommenders_torch.serving.model_io import (
    load_model,
    model_config,
    save_model,
)
