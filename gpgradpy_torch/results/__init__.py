from .plt_optz_results import PltOptzResults  # noqa: F401
