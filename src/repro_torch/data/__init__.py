from .corpus import SyntheticCorpus  # noqa: F401
from .stats import CorpusStats  # noqa: F401
