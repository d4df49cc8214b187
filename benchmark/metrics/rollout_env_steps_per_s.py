"""The rollout's rate, from the agent's own T_rollout: every env step of
the window's epochs over their rollout time (on several ranks, each
epoch's slowest rank)."""


def read(ctx):
    ranks = ctx["ranks"]
    steps = sum(s["steps"] for s in ranks[0]["stats"])
    t = sum(max(r["stats"][i]["T_rollout"] for r in ranks)
            for i in range(len(ranks[0]["stats"])))
    return steps / t
