from .corpus import SyntheticCorpus, read_text_corpus  # noqa: F401
from .loader import LoaderConfig, data_state, make_batch  # noqa: F401
from .stats import CorpusStats  # noqa: F401
