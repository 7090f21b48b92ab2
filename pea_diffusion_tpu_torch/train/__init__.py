from .kd import KDModels, KDState, kd_loss, make_train_step, teacher_encode_prompt
from ..checkpoints.orbax_io import export_adapter, import_adapter
from .trainer import KDTrainer

__all__ = ["KDModels", "KDState", "kd_loss", "make_train_step", "teacher_encode_prompt",
           "KDTrainer", "export_adapter", "import_adapter"]
