from .corpus import SyntheticCorpus, read_text_corpus  # noqa: F401
from .stats import CorpusStats  # noqa: F401
