from . import vocabulary, database
from .vocabulary import Vocabulary, train_vocabulary
from .database import KeyFrameDatabase

__all__ = ["vocabulary", "database", "Vocabulary", "train_vocabulary",
           "KeyFrameDatabase"]
