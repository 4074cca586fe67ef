from .executor import DistGroupByPlan, GroupByResult, distributed_groupby

__all__ = ["DistGroupByPlan", "GroupByResult", "distributed_groupby"]
