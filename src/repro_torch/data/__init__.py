from repro_torch.data.loader import ClassificationLoader
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import (CLASS_NAMES, N_CLASSES, EmotionDataset,
                                        lm_batches, lm_stream, make_emotion_dataset)

__all__ = ["CLASS_NAMES", "ClassificationLoader", "EmotionDataset",
           "N_CLASSES", "dirichlet_partition", "iid_partition", "lm_batches",
           "lm_stream", "make_emotion_dataset"]
