"""``gwen_tpu_torch.nn.core.linear``: every product with a weight and a
bias, the bias and a following ReLU in the product's epilogue. Held
against the expression it replaced, ``x @ w.to(x.dtype) + b.to(x.dtype)``
(then ``relu``), forward and gradient, on each of its routes; the route
counters say which route each shape takes."""

import pytest
import torch

from gwen_tpu_torch.nn import core

# name: (x shape, N, route)
SHAPES = {
    "2d": ((37, 16), 24, "epilogue"),
    "3d": ((3, 11, 16), 24, "epilogue"),
    "k1": ((2, 13, 1), 8, "outer"),
    "n1": ((19, 16), 1, "plain"),
    "1row": ((1, 16), 24, "plain"),
}


def operands(shape, n, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=gen, dtype=dtype)
    w = torch.randn(shape[-1], n, generator=gen, dtype=torch.float64)
    b = torch.randn(n, generator=gen, dtype=torch.float64)
    params_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    return x, w.to(params_dtype), b.to(params_dtype)


def old(x, w, b, relu):
    y = x @ w.to(x.dtype) + b.to(x.dtype)
    return torch.relu(y) if relu else y


@pytest.fixture
def routes(monkeypatch):
    """The route counters, from zero."""
    monkeypatch.setattr(core.linear, "routes", dict.fromkeys(core.linear.routes, 0))
    return core.linear.routes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("relu", [False, True], ids=["bias", "relu"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_linear_matches_the_old_expression(name, relu, dtype, routes):
    shape, n, route = SHAPES[name]
    x, w, b = operands(shape, n, dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    got = core.linear(*leaves, relu=relu)
    assert got.shape == (*shape[:-1], n) and got.dtype == dtype
    assert routes == {r: int(r == route) for r in routes}
    refs = [t.clone().requires_grad_() for t in (x, w, b)]
    want = old(*refs, relu)
    torch.testing.assert_close(got, want)
    cot = torch.randn(want.shape, generator=torch.Generator().manual_seed(1), dtype=dtype)
    got.backward(cot)
    want.backward(cot)
    for mine, theirs in zip(leaves, refs):
        assert mine.grad.dtype == theirs.grad.dtype
        torch.testing.assert_close(mine.grad, theirs.grad)


@pytest.mark.parametrize("relu", [False, True], ids=["bias", "relu"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_linear_gradcheck(name, relu, routes):
    shape, n, route = SHAPES[name]
    x, w, b = (t.requires_grad_() for t in operands(shape, n, torch.float64, seed=2))
    if relu:  # keep the pre-activations off the ReLU's kink
        with torch.no_grad():
            b += torch.where(b >= 0, 0.5, -0.5)
    assert torch.autograd.gradcheck(lambda *t: core.linear(*t, relu=relu), (x, w, b))
    assert routes[route] > 0 and sum(routes.values()) == routes[route]


@pytest.mark.parametrize("name", ["2d", "3d", "k1"])
def test_linear_bf16_rounds_once(name, routes):
    """In bf16 the bias joins the float32 sum before the one rounding, where
    the old expression rounded twice: within one bf16 ulp at max|old|."""
    shape, n, _ = SHAPES[name]
    x, w, b = operands(shape, n, torch.bfloat16, seed=3)
    want = old(x, w, b, relu=False)
    exact = x.double() @ w.to(torch.bfloat16).double() + b.to(torch.bfloat16).double()
    got = core.linear(x, w, b)
    ulp = 2.0 ** (torch.frexp(want.double().abs().max())[1].item() - 8)
    assert (got.double() - want.double()).abs().max().item() <= ulp
    assert ((got.double() - exact).abs() <= (want.double() - exact).abs() + ulp / 2).all()


@pytest.mark.parametrize("relu", [False, True], ids=["bias", "relu"])
def test_linear_saves_what_autograd_saved(relu, routes):
    """The product's node keeps ``x`` and the cast weight, and the ReLU's
    node, as autograd's ReLU, the output: no more than autograd kept for the
    old expression, and the ReLU's mask a node of its own before the
    product's backward."""
    x, w, b = operands((2, 40, 16), 24, torch.bfloat16)
    w.requires_grad_()
    b.requires_grad_()
    y = core.linear(x, w, b, relu=relu)
    node = y.grad_fn.next_functions[0][0]  # under the reshape
    if relu:
        (out,) = node.saved_tensors
        assert out.data_ptr() == y.data_ptr()
        node = node.next_functions[0][0]
    x2, wc = node.saved_tensors
    assert x2.data_ptr() == x.data_ptr()
    assert wc.dtype == torch.bfloat16 and wc.shape == w.shape


def test_mlp_apply_fuses_relu_and_keeps_other_activations(routes):
    gen = torch.Generator().manual_seed(4)
    params = core.mlp_init([16, 24, 24, 8], gen, "cpu")
    x = torch.randn(5, 30, 16, generator=gen)

    def composed(act):
        h = x
        for i in range(3):
            p = params[f"layer_{i}"]
            h = old(h, p["w"], p["b"], relu=False)
            h = act(h) if i < 2 else h
        return h

    torch.testing.assert_close(core.mlp_apply(params, x), composed(torch.relu))
    torch.testing.assert_close(core.mlp_apply(params, x, activation=torch.tanh),
                               composed(torch.tanh))
