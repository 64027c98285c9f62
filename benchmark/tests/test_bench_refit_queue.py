"""The refit route's queued window (`ahead` > 0): every refit it issues is
waited for and counted, none more than `ahead` places behind the newest,
and the queued answers are the closed loop's."""

import time

import pytest
import torch
from conftest import TINY

import harness


def _tiny_refit_ctx(ahead: int, traced: bool = False):
    cell, config, traffic = harness.resolve_cell(harness.load_manifest(), "gblup-refit-int8")
    config.update(TINY["gblup-refit-int8"][0])
    traffic.update({**TINY["gblup-refit-int8"][1], "ahead": ahead})
    route = harness.route_module(traffic)
    ctx = harness.Ctx(cell, config, traffic, 11, 0.3, traced, torch.device("cpu"), time.perf_counter())
    route.setup(ctx)
    return route, ctx


@pytest.mark.parametrize("ahead", [1, 3])
def test_queued_window_waits_for_every_refit(ahead, monkeypatch):
    route, ctx = _tiny_refit_ctx(ahead)
    issue, log = route._issue, []

    def logged(ctx, st, row):
        wait = issue(ctx, st, row)
        log.append(("issue", row))

        def logged_wait():
            log.append(("wait", row))
            wait()
        return logged_wait

    monkeypatch.setattr(route, "_issue", logged)
    route.window(ctx)
    k = ctx.window["requests"]
    assert k >= ahead + 1 and len(ctx.window["latencies_s"]) == k
    assert [r for what, r in log if what == "wait"] == list(range(k))
    pending = 0
    for what, _ in log:
        pending += 1 if what == "issue" else -1
        assert 0 <= pending <= ahead + 1
    assert pending == 0 and log[-1] == ("wait", k - 1)


def test_queued_answers_are_the_closed_loops():
    route, closed = _tiny_refit_ctx(0)
    route.window(closed)
    route, queued = _tiny_refit_ctx(3)
    route.window(queued)
    k = min(closed.window["requests"], queued.window["requests"])
    assert torch.equal(closed.state.out[:k], queued.state.out[:k])
    checks = route.check(queued)
    assert checks["gebv_gap"][0] <= checks["gebv_gap"][1] and checks["refits_not_finite"] == (0, 0)


def test_queued_traced_requests_drain_at_the_first_and_last():
    route, ctx = _tiny_refit_ctx(3, traced=True)
    st = ctx.state
    route.traced_request(ctx, 0)
    assert not st.sent
    for j in range(1, st.T - 1):
        route.traced_request(ctx, j)
        assert len(st.sent) == min(j, 3)
    route.traced_request(ctx, st.T - 1)
    assert not st.sent
